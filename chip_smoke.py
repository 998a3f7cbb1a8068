#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA Hopper GPU (the
kernels compile for sm_90a) and the CUDA toolkit:

  (a) device: the card's name and power limit (nvidia-smi), the torch,
      CUDA, nvcc and triton versions; TF32 off for matmul and cuDNN;
  (b) build: compiles csrc/*.cu with nvcc at first use (one process per
      source, side by side) and prints each kernel's registers and spills
      (the int8 GEMM by epilogue and tile width, the attention program by
      bias and int8 q k and its out_res instantiation, K11, K12 by cluster
      and widths), ptxas's wgmma-serialisation warnings (C7512, C7514), the
      attention program's blocks an SM and K11's and K12's clusters resident
      at once;
  (c) kernels: K1 flash_attention_packed and K6 focal_attention_fused (K1's
      bf16 program, which K7 and K8 share, also at N 1 to 1370 around its
      64-row tiles, ViT-B and ViT-L heads, and under a permutation probe: V
      one-hot by key index; its int8 instantiation, K10, K10b and K9, at N 1
      to 1370, ViT-B and ViT-L heads, on rows of +-127 and under the same
      probe, K10b on a zero row bit for bit K10, K9 bit for bit K10 where
      every head of a row has the same largest value, K9's per-(row, head)
      quantiser Qh bit for bit its plain version), and
      the int8 kernels K2, K3, K4a, K4b, K4 and K5, at the slice shapes, at
      the ragged N 257 and 481 (K1 also at the progressive filter's 826 and
      416) and at ViT-L widths, and the biased and
      int8-QK^T attention kernels K7, K10 and K10b (N 481, 1370, 257, 416,
      ViT-L width; bias rows of zeros, log counts and an empty group; K7
      also in float32), against their plain PyTorch versions, each error
      printed beside its stated tolerance; quantize_rows (Q), which K10 and
      K10b call on q and k together (one launch), bit for bit against its
      plain version; K8
      flash_attention on contiguous [B, N, H, 64] tensors and on the column
      slices of one fused projection (N 257, 481, 1370, ViT-L heads, bf16 and
      float32, also bit for bit against K1 on the same memory), K13 int8_proj
      at the four projection shapes of a block (fc2 reads rows 3072 wide),
      ViT-L widths and N 257 and 481, K15 int8_gemm_fused at M 8 x 1370 and
      8 x 481, K14 int8_fc1_gelu against its plain version and against K4a
      on rows the plain layernorm normalised; the fused variants K9
      flash_attention_packed(int8_dots=True), K11 flash_attention_packed_out_res
      and K12 int8_attnout_mlp_ln at N 1370, 481, 257 and ViT-L widths (K11 also
      by the share of its int8 context values that sit one step from the plain
      version's; K12 also against K3 -> K4, which it must not equal bit for
      bit), and what each raises on; K11's kernel (the out_res instantiation
      of K1's program, a thread-block cluster of one CTA a head over a 64-row
      tile): its cluster rule equal to the wrapper's, N 1 to 1370 around its
      tiles, every head count from 1 to 16, a batch element whose context is
      zero (c8 0, the scale's floor, out = res + ls b), the int8 context and
      scales return_quantised gives, one device kernel a call, its bits
      repeated run to run; K12's one kernel (a thread-block cluster
      a 64-row tile) at M 10960, 8 x 481, 8 x 257, 17 and 1 rows, ViT-B,
      ViT-L and the tests' widths, rows of zeros, its shape rule equal to the
      wrappers' and one device kernel a call; the one-pass fc1 GEMM of K4a and
      K14 (a thread-block cluster a 64-row tile) bit for bit against the plain
      versions at F 256, 512, 3072 and 4096, M 10960, 8 x 481 and 17 rows (K4a
      on rows whose layernorm is exact), rows of zeros (the scale's floor) and
      a cluster probe (each CTA in turn holds every row's maximum), its
      clusters resident at once and its launches per K4a call; the strict
      policy's f32 programs: K1's register-tiled program (which K7 and K8
      launch too) at N 1 to 1370 with ViT-B and ViT-L heads and under the
      permutation probe in f32, K7 on bias rows of zeros (bit for bit K1),
      an empty group and every key, K8 on the column slices of a fused
      projection (bit for bit K1), K6's scores and attend passes at B8 N1369
      D768, D 1024, N 1 to 1369 and widths 64 to 1024 on both block shapes,
      run to run and with NaN past N; K6's bf16
      program at D 64 to 1024 and N 1 to 1369 around its 64-row and 64-key
      tiles (attended within 1e-2 of the plain version's largest value), its
      outputs bit-identical from run to run, and rows past N filled with NaN
      kept out of its outputs; the int8 GEMM program of K2, K5, K3, K4b, K13
      and K15 (int8_gemm_tma_kernel: persistent CTAs, a TMA producer warp,
      outputs stored by TMA): its tile-width rule equal to the wrappers' at
      every width up to 8192, every epilogue against its plain version at each
      tile width and at M 10960, 8 x 481, 8 x 257, 17 and 1 rows (bit-equal
      but K2, whose layernorm sums in another order),
      tile counts under, at and over its resident CTAs, outputs that are the
      first M rows of a larger buffer (no row past M written), and one GEMM
      launch a call after the prologue;
  (d) slices: guided ViT-B 518x518 inference (2 focal iterations, random
      weights from a seeded torch.Generator) answering a 9-instruction
      batch, a mixed batch of 8 and an unguided request through uint8 ->
      resize_normalize -> CognitiveAimModel, under the default bf16 policy
      (K1 12 and K6 2 launches per forward) and under the int8 policy (K2,
      K1, K3, K4, K4a, K4b 12 and K5, K6 2 per forward); checks the outputs
      and the launch counts; then the same requests through the plain
      versions on the same weights, int8 against the default policy, and a
      strict-f32 forward at 224x224 against its plain twin (K1 12 and K6 2
      launches, on the f32 programs); then the
      token-filter fast path on the same seeded weights, a mixed batch of 8
      through four slices: int8 2:0.35 (K1 12), int8 2:0.35@p (K1 2, K7 10;
      also an unguided request), int8 2:0.35@p with pallas_packed_i8qk (K10
      2, K10b 10, Q 12) and default 1:0.6,2:0.3@f4 (K1 12 at N 1370, 826, 416),
      each also through the plain versions, with the stream lengths, the
      frozen dropped tokens and the overlap of the two paths' kept sets
      (at least 0.98) checked; then the adapter (LoRA) slices on seeded
      weights with non-zero lora_B, a mixed batch of 8, each through kernels
      and plain versions: default policy with rank 16 on attn_out (K1 12,
      K6 2), the same with attn_impl="pallas" (K8 12, K1 0), int8 with rank
      64 on qkv, attn_out, fc1 and fc2 (the unchained block: K15 12, K1 12,
      K2 = K3 = K4 = 0, K5 2, K6 2), the same weights folded by
      merge_lora_params under int8 with 2:0.35 (chained again: K2, K3, K4 12,
      K15 0), 2:0.35@m@p (K1 2, K7 10; every patch position equals its
      representative's row) and 2:0.35@d, and folded against runtime adapters
      under the default policy; then the fused slices on the int8 slices'
      weights with CAIM_FUSE_AOMLP=1 set and restored around them: F1 exact and
      F2 2:0.35 (K12 12, K3 = K4 = K4a = K4b = 0, K2 12, K1 12, K5 2, K6 2),
      each against its plain twin under the variable and against the unfused
      slice; and K11 and K9 in place: the int8 model's 12 blocks as chained
      steps assembled by hand (K2 -> K11 -> K4; K2 -> K9 -> K3 -> K4) against
      the same steps' plain versions and against K2 -> K1 -> K3 -> K4;
  (e) times with CUDA events: every kernel beside its plain version and
      its bound (the f32 programs of K1, K7, K8 and K6 too, bound on the f32
      FMA pipes), K1, K7 and K8 beside scaled_dot_product_attention (each
      ratio printed, timed in turns; K1 also at N 481, by CUDA graphs,
      whose device time the host's launch rate does not mask), K10 and K10b
      by CUDA graphs in turns with K1 and K7 (the attention kernel alone and
      with its quantising launch), K13
      beside int8_ops.int8_linear at the three shapes the unchained block
      gives that function, the B=8 forward under both policies, through the
      int8 filtered slices and through the int8 adapter slice, and the host
      time to enqueue one forward; K9, K11 and K12 in turns with the kernels
      they fuse (K1; K1 + K3; K3 + K4), K12 and K3 -> K4 also by CUDA graphs
      in turns at N 1370 and 481, K11 and K1 -> K3 at N 1370, 481 and 257,
      K9's kernel and wrapper by CUDA graphs in
      turns with K10's at N 1370 and 481, the int8 exact and 2:0.35 forwards
      with CAIM_FUSE_AOMLP off and on, and the hand-assembled 12 blocks
      through K1 + K3, K11 and K9; K2, K3, K4b, K5, K13 and K15 also by CUDA
      graphs, each beside torch._int_mm at its [M, K] x [K, N] (a yardstick of
      the product alone, not a port); K4a, K14, K12 and K6 also by CUDA graphs
      (at ViT-L's widths in phase (m)), and the device
      time of one exact forward under each policy (torch.profiler, kernels
      summed);
  (f) serving: the port's engine (cognitive_aim_tpu_torch.api) and HTTP
      server (cognitive_aim_tpu_torch.serve) on the card at ViT-B 518x518,
      eval_configs/full_cognitive_fast_tpu.yaml (use_lora off, as the main
      path has no adapters), policy int8, pallas_packed, seeded weights:
      an exact engine (token filter off) saves its float32 npz, a second
      engine loads it and answers a batch of 8 bit for bit as the first; the
      config's 2:0.35 engine loads the same npz and warns that it carries no
      filter stamp, and under CAIM_REQUIRE_FILTER_STAMP=1 refuses it; then
      each engine behind serve(port=0, max_batch=8) on loopback: /healthz,
      24 concurrent /predict of PNGs with mixed instructions (each within
      2e-2 of the engine's own batched forward of the same pixels), one
      /predict_batch of 10 server-local JPEGs (the tail chunk padded; equal
      to predict_paths_batched on the same files, with the host decoder
      named), a bad request (400), the launches of one served forward (one
      replay of the max_batch graph the server's warm-up captured, read from
      a profiler trace as (k) reads them: K1, K2, K3, K4, K4a, K4b 12, K5, K6 2;
      K1 at N 1370 in the captured forward, under 2:0.35 at 481 after block
      2), and a timed load (96 requests from 16 threads):
      requests/s, p50 and p99 latency beside the card's name and power
      limit, and the time per stage (host decode and resize, dispatch: the
      copies into the graph's inputs and its replay, the forward on the
      stream by CUDA events, drain). Every engine forward from here on is a
      replay of a CUDA graph captured at its signature's first forward
      (core/compiled.py); a replay runs no wrapper, so its launches are read
      from the device, as (k) says. Phase (a) prints what
      the host offers that path (PIL, PyYAML, matplotlib, g++, the native
      loader's build); a step a missing package stops is printed as not
      driven;
  (g) training: configs/experiment_B.yaml (ViT-B/14 at 224, LoRA rank 16 on
      attn_out, every parameter trained, 6 focal iterations, batch 128,
      accumulation 4) under the default policy with pallas_packed, seeded
      weights (lora_B drawn N(0, 0.02)): the gradients of the trainer's loss
      on one batch (dropout off, noise 0) through the kernels and through the
      plain versions, in float32 (every gradient within 1e-4, relative L2;
      the analytically zero ones within 1e-6 of the global norm) and in bf16
      (global relative L2 and loss within 2e-2; per parameter the kernels no
      further from the float32 gradient than twice the plain versions plus
      1e-2); the launches of one micro-step (K1 24 and K6 6 with
      per-block recompute, K1 12 without, every other kernel 0); every
      kernel without a backward raising under grad; the eager micro-step's
      time (``train_step(eager=True)``; CUDA events, median of the steps
      after the first), images/s and peak memory with recompute on and
      off; one profiled eager micro-step (K1's and
      K6's forward kernels, the plain recompute of their backward) and K1
      forward + backward at the training shape beside the plain version and
      scaled_dot_product_attention; then train_torch.main on a synthetic
      dataset (512 train and 128 val PNGs of 256x256 with depth maps, from a
      numpy seed) for 2 epochs: 8 micro-steps, 2 optimizer updates, finite
      losses, the parameters unmoved before the first update and moved at
      each, the checkpoints written, the run's graphs (two micro-step kinds,
      one eval batch shape, each counted by the wrappers at its eager first
      run and its capture, 8 replays) and launches, and
      model_best.npz served by the port's engine within 1e-5 of the
      trainer's own eval forward on a val batch. Phases (d) to (f) run
      under torch.no_grad(), as the engine serves; a ``training`` JSON line
      holds (g)'s numbers beside the card's name and power limit;
  (h) certification (cognitive_aim_tpu_torch/certify/), through the
      functions its CLIs call, at ViT-B width with 6 focal iterations: the
      procedural scenes (512 training scenes at 224x224 from seed 0, 32
      held-out at 224 and 16 at 518 from seed 12345, timed); the guided
      pretrain (certify.pretrain --guided, 224x224, batch 32, lr 1e-4,
      CERT_STEPS steps, the default policy, pallas_packed, uint8 scenes
      staged on the card): finite losses, the last 20 below the first 20,
      the held-out AbsRel unguided and worst-instruction below the seeded
      model's, K1 and K6 launched as phase (g)'s formula gives for the
      steps' graphs (each kind's eager first run and capture) and the eager
      evals, every other kernel 0 times; policy_delta on those
      weights at 518x518, batch 8: int8 and int8 + 2:0.35 against the strict
      f32 path for the 9 instructions, int8 alone within the 1% budget;
      delta_sweep --measure-only at 224 on the 32 held-out scenes for
      2:0.25, 2:0.35 and 2:0.25@p, and 2:0.35 measured through the kernels
      and through the plain versions on the same weights (depth within
      2e-2, the strict f32 reference within 1e-4, kept sets overlapping by
      at least 0.98); attention_stats, random init against the trained
      weights on 16 scenes (finite, entropies in (0, 1]); the written npz
      through CognitiveAimInference at 518 and through delta_sweep's loading
      against the in-memory model (within 1e-5); every kernel's launches in
      the phase (``launches_certification``; for the f32 programs, those of
      forwards under a float32 policy); no module of JAX, of the JAX package
      or of scripts/ imported. A ``certification`` JSON line holds its
      numbers;
  (i) parallel (core/mesh.py, parallel/) at world 1, the card's one rank,
      NCCL started from a file rendezvous: the engine's data-parallel path
      (predict_paths_batched(mesh=make_mesh())) at ViT-B 518 int8, exact and
      2:0.35, on 32 seeded JPEGs with mixed instructions, bit for bit
      mesh=None's list, with the launches of its replays read from their
      trace as (k) reads them (K1, K2, K3, K4, K4a, K4b 12; K5, K6 2 a
      forward); ViT-L 518 under the default policy, B 8, seeded
      weights, sequential (K1 24, K6 2) and under the GPipe schedule
      (make_pipeline_mesh(1), 4 microbatches: K1 24 x 4, K6 2), depth and
      confidence within 2e-2 relative; configs/experiment_B.yaml's trainer
      for 3 steps at batch 32 in float32 on make_mesh() with
      tensor_parallel against the trainer without a mesh, from the same
      weights and generator: losses and parameters within 1e-6 relative, and
      both steps' CUDA-event times; experiment_B's trainer at TP 2 as two
      gloo processes sharing the card, one step against world 1's, and one
      more under the token filter 2:0.35 (filtered in training: each rank
      ranks by the CLS rows of its 6 heads, summed over model). The mesh=None
      runs come before the process group starts. A ``parallel`` JSON line holds the numbers and
      each kernel row its launches there (``launches_parallel``);
  (j) export (scripts/torch_export_model.py): phase (f)'s engine at ViT-B
      518 int8, pallas_packed, seeded weights, its serving forward
      (depth, confidence) exported with torch.export at B 16 exact and at
      B 8 with the config's 2:0.35, saved, loaded and rebuilt from its npz
      as a consumer does: one caim node per launch in the program (K2, K1,
      K3, K4a, K4b 12; K5, K6 2), the trace itself launching nothing, one
      forward of the loaded program within rtol 2e-5 / atol 1e-6 of the live
      forward (bit-equal expected) with its launches (K2, K1, K3, K4a, K4b
      12; K5, K6 2; K4's own count, outside any op, 0), which show that the
      artifact runs the kernels; export, save and load seconds, artifact MB,
      the loaded and live forwards by CUDA events (median of 3, range) and
      their host enqueue; the loaded program also captured and replayed
      by the engine's graph helper (core/compiled.py): bit for bit its eager
      run, the same launches (read from the replay's trace as (k) reads
      them), its time beside the two. An ``export`` JSON
      line holds them and each kernel row its launches there
      (``launches_export``);
  (k) compiled forward (core/compiled.py): phase (f)'s engine (ViT-B 518
      int8, pallas_packed, seeded weights, sampled noise) guided on float
      images at B 8 and 16, exact and 2:0.35, at B 8 exact also unguided and
      on uint8 images (captured by predict_paths_batched), and the default
      policy at B 8: each signature's capture seconds and the bytes it added
      to the pool, one replay against the eager ``engine.model(...)`` with
      the replay's seed (rtol 2e-5 / atol 1e-6, bit-equal expected), the
      launches of a replay (int8: K1, K2, K3, K4, K4a, K4b 12; K5, K6 2;
      default: K1 12, K6 2), host time a replay beside the eager
      enqueue, both by CUDA events (median of 3, range), the graphs held
      and the pool. A ``compiled`` JSON line holds them beside the card's
      name and power limit, each kernel row its launches a replay
      (``launches_compiled``). A replay runs no Python, so no wrapper counts
      it: the eager forward and the replay each run once under
      torch.profiler, and the replay must run no wrapper and the caim
      kernels the eager forward's wrappers launched, in the same order; each
      wrapper's launches a replay are then its count of the eager forward
      (each trace counts the kernels between two marker kernels, and is
      taken again when the profiler dropped a marker);
  (l) compiled training (train/trainer.py, core/compiled.py's GraphCache):
      phase (g)'s configuration from seeded weights, 8 micro-steps (two
      updates) from two device batches in turns and a generator a step,
      eagerly twice (``train_step(eager=True)``: eager's own spread) and
      through the trainer's graphs twice (the first run captures each
      micro-step kind at its first call, the second only replays), per-block
      recompute on: each replayed run's losses and parameters bit for bit
      the eager run's where eager repeats its bits, else within twice its
      spread; the launches of a replay read from its trace (K1 24, K6 6, the
      eager step's kernels in order); the micro-step by CUDA events (median
      of the steps after the first, range), host time a call, peak memory,
      each graph's capture seconds and pool MiB; then the alt_model pair
      (2:0.35 in training, alternating with the model without it) at 4
      blocks, batch 32, the same way. A ``training_compiled`` JSON line holds
      them, each kernel row its launches a replay
      (``launches_training_compiled``);
  (m) ViT-L (the JAX package's backbone_size: large, bench.py --backbone
      large): phase (f)'s config with the ViT-L backbone (24 blocks, D 1024,
      16 heads of 64, MLP 4096), int8, pallas_packed, 2 focal iterations,
      seeded weights, noise zeros, through the engine exact and at 4:0.25,
      at B 8 and 24: each signature captured, one replay bit for bit the
      eager ``engine.model(...)``, host time a replay, both forwards by CUDA
      events and images/s; at B 8 the launches of a replay read from its
      trace (K1, K2, K3, K4, K4a, K4b 24; K5, K6 2) and the forward through
      the kernels against the plain versions (depth and confidence within
      2e-2) and, at 4:0.25, the stream lengths (1370 to block 3, 344 after),
      the frozen dropped tokens and kept sets overlapping by at least 0.98;
      the exact engine's graph captured again under CAIM_FUSE_AOMLP=1 (K12
      24, K3 = K4 = K4a = K4b = 0), against its plain twin and within 2e-2 of
      the unfused forward; the strict policy on the same weights at B 8 (K1
      and K6 on their f32 programs, 24 and 2; within 1e-4 of the plain
      path) and the int8 and int8 + 4:0.25 worst-instruction depth AbsRel
      against it on 8 structured scenes, labelled as taken on seeded
      weights (no budget); experiment_B's trainer with the ViT-L backbone
      at 518, B 8, accumulation 2, 3 micro-steps eagerly twice and through
      the trainer's graphs twice, bit for bit, with peak memory (K1 48, K6 6
      a replay); and each kernel of the path at its ViT-L shape beside its
      plain version, bound and (K1) scaled_dot_product_attention. A
      ``vit_l`` JSON line holds them; each kernel row its launches there
      (``launches_vit_l``) and its ViT-L times (``vit_l``).

The line before the last is one JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
Any failure raises and exits non-zero. Without a CUDA device it exits 2.
``--kernels-only`` checks and times the kernels alone, drives no slice and
prints no result; ``--parallel-only`` builds the kernels and runs phase (i)
alone, ``--export-only`` phase (j) alone, ``--compiled-only`` phase (k)
alone, ``--training-compiled-only`` phase (l) alone, ``--vit-l-only``
phase (m) alone, and none prints a result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of the kernel checks (phase c), max |kernel - plain| over all
# elements; the plain version runs in float32 on the same input values
TOL_BF16_OUT = 2e-2  # bf16 outputs of magnitude <~2: bf16 spacing there is
#                      <=2^-7, plus P rounded to bf16 before the PV product
# the bf16 attention program of K1, K7, K8 (csrc/flash_wgmma.cu) at N 1..1370:
# twice its largest error measured on the card (4.6e-3, at short N), so that
# a lost key tile at N 1370 (outputs of magnitude ~0.04) cannot pass
TOL_FLASH_BF16 = 1e-2
TOL_F32_OUT = 1e-4  # f32 kernel vs f32 plain: summation order only
# K6's bf16 attended (csrc/focal_attention.cu), relative to max |plain|: the
# bf16 output's rounding is at most 2^-8 of the largest value and rounding the
# normalised P to bf16 adds ~1e-3 of it, so 1e-2 holds with twice the worst
# case, where an absolute 2e-2 would pass 0.8 x attended at N 1369 (RMS 0.017)
TOL_FOCAL_REL = 1e-2
TOL_VIEWS = 1e-5  # K6's f32 row views (colmean, diag, rowmax), values <= 1
# int8 kernels: a bf16 output may round the other way than the plain
# version's (one bf16 step is 2^-7 = 7.8e-3 of the value) and an int8
# activation may differ by 1 where the layernorm's summation order moves a
# value across a rounding boundary: max |kernel - plain| <= 1e-2 max(1, |plain|)
TOL_INT8_REL = 1e-2
TOL_INT8_SHARE = 1e-2  # share of int8 outputs that differ, each by at most 1
# the f32 row scales, relative: 2e-4, but for a row whose quantised layernorm
# output differs from the plain version's in one element (see above), which
# moves that row's maximum by one int8 step of one input, ~1e-3 of it: under
# 1e-3 of the rows may exceed 2e-4, none 5e-3
TOL_INT8_SCALE = 2e-4
TOL_INT8_SCALE_ROWS = 1e-3
TOL_INT8_SCALE_WORST = 5e-3
# slice (phase d): kernel path vs plain path on the same weights and inputs
TOL_SLICE_BF16 = 2e-2  # relative, depth and confidence, bf16 backbone
TOL_SLICE_F32 = 1e-4  # relative, strict-f32 policy
TOL_POLICY = 2e-2  # relative depth, int8 policy against the default policy
POLICY_BUDGET = 1e-2  # the 1% AbsRel budget of scripts/policy_delta.py, for scale
# filtered slices: the kept set is a discrete function of the importances, and
# neighbouring importances at the keep boundary lie ~5e-7 apart at 1369 tokens,
# so bf16 differences between kernels and plain versions move a few tokens
# across it: share of a sample's kept set found in the other path's
MIN_KEPT_OVERLAP = 0.98
# K14 on rows the plain layernorm normalised against K4a on the raw rows: K14
# reads the normalised rows rounded to bf16 (2^-9 relative), K4a quantises them
# from f32, so up to a tenth of the int8 activations differ by 1 and the hidden
# moves by about one of its own int8 steps (1/127 of a row's maximum): max
# |dequantised difference| <= 3e-2 of the largest hidden value
TOL_K14_NORMED = 3e-2
# adapters change the answer: least relative change of depth, adapters on vs off
MIN_ADAPTER_EFFECT = 1e-4
# 12 chained int8 blocks assembled by hand, kernels against plain versions and
# one attention route against another, on the hidden state [8, 1370, 768]: int8
# steps that land apart feed the next block, and the largest of 8.4 M differences
# is a few bf16 steps of a large value. RMS difference over RMS value, and the
# largest difference over the largest value; measured 1.3e-2 and 2.4e-2 for K11
# (6.8% of its int8 context values sit one step from the plain version's, in
# each of 12 blocks)
TOL_CHAIN_RMS = 2e-2
TOL_CHAIN_MAX = 5e-2
# K12 against K3 -> K4: the pair rounds the post-attention residual to bf16
# (2^-9 of its value) before the layernorm and the last add, K12 carries it in
# f32, so the outputs sit up to one bf16 step (2^-7 of the value) apart:
# max |K12 - pair| <= 2e-2 max(1, |pair|), the JAX package's own tolerance
TOL_K12_SPLIT = 2e-2
# K11's int8 context against the plain version's: the share of values one step
# apart (see phase_fused_kernels)
TOL_K11_CTX_SHARE = 1e-1  # measured 6.3e-2 .. 6.8e-2 at the four shapes
# ... and its row scales, relative: the maximum of a row of sums with mixed
# signs moves by more than one rounding of P (2^-8 between the two); measured
# up to 4.9e-3
TOL_K11_SCALE = 1e-2

# the card's published dense peaks (NVIDIA H100 SXM data sheet; f32: the FMA
# pipes, outside the tensor cores, as the strict policy keeps TF32 off)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the attention programs' checks: lengths around their 64-row tiles and the
# model's stream lengths (1370 unfiltered; 826, 481, 416 after a filter)
FLASH_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 257, 416, 481, 826, 1370)


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def tool_version(cmd) -> str:
    exe = shutil.which(cmd[0]) or (
        "/usr/local/cuda/bin/nvcc" if cmd[0] == "nvcc" else None)
    if exe is None or not os.path.exists(exe):
        return "not found"
    out = subprocess.run([exe, *cmd[1:]], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn: reps calls captured in one CUDA graph,
    the graph replayed. Where a wrapper takes longer on the host than its
    kernel on the device (N 481), cuda_ms reads the host's launch rate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=replays, warmup=1) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(n_bytes: float, n_ops, kind: str = ""):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move n_bytes once or to do n_ops at its peak rate, whichever is larger.
    n_ops: a count of operations of ``kind``, or {kind: count} where a
    kernel's products are of two types."""
    ops = n_ops if isinstance(n_ops, dict) else {kind: n_ops}
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases ----
def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log("(a) device")
    log(smi)
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc [{tool_version(['nvcc', '--version'])}] triton {triton_v} "
        f"python {sys.version.split()[0]}")
    return smi


def phase_build():
    from cognitive_aim_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.library()
    secs = time.perf_counter() - t0
    log(f"(b) build: {secs:.1f} s (nvcc {_build.build_seconds} s; "
        f"{'built' if _build.build_seconds is not None else 'cached'}) -> {lib._name}")
    ptxas = os.path.join(os.path.dirname(lib._name), "ptxas.log")
    if os.path.exists(ptxas):  # registers and spills of each kernel
        import re

        text = open(ptxas).read()
        epilogues = ("kQKV", "kResidual", "kPlain")
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads.*?Used (\d+) registers", text, re.S):
            name = m.group(1)
            gemm = re.search(r"int8_gemm_tma_kernelILi(\d)ELi(\d+)E", name)
            if gemm:  # the int8 GEMM's instantiations: <epilogue, tile columns>
                name = f"int8_gemm_tma_kernel<{epilogues[int(gemm.group(1))]}, {gemm.group(2)}>"
            k12 = re.search(r"AoTileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
            if k12:  # K12's: <CTAs of the cluster, columns a CTA, a sweep's, sweeps>
                name = (f"attnout_mlp_kernel<cluster {k12.group(1)}, KC {k12.group(2)}, "
                        f"NWC {k12.group(3)}, sweeps {k12.group(4)}>")
            f32 = re.search(r"(focal_f32_\w+_kernel)ILi(\d+)E", name)
            if f32:  # K6's f32 passes by the side of their blocks
                name = f"{f32.group(1)}<{f32.group(2)} x {f32.group(2)}>"
            elif "flash_f32_kernel" in name:
                name = f"flash_f32_kernel<{'bias' if 'ILb1E' in name else 'no bias'}>"
            flash = re.search(r"flash_wgmma_kernelILb(\d)ELb(\d)ELb(\d)E", name)
            if flash and flash.group(3) == "1":  # K11: its out_res instantiation
                name = "flash_wgmma_kernel<out_res> (K11)"
            elif flash:  # the attention program's: <bias, int8 q k> (K10, K10b: i8qk)
                name = (f"flash_wgmma_kernel<{'bias' if flash.group(1) == '1' else 'no bias'}, "
                        f"{'i8qk' if flash.group(2) == '1' else 'bf16'}>")
            log(f"  {name[:72]}: {m.group(4)} registers, spills "
                f"{m.group(2)}/{m.group(3)} bytes")
        # ptxas's notes that it serialised a kernel's wgmmas (C7512, C7514)
        serial = [f"{m.group(3)[:60]}: {m.group(1)}, {m.group(2)}" for m in re.finditer(
            r"\((C751[24])\) Potential Performance Loss: wgmma.mma_async instructions are "
            r"serialized due to ([^\n]*?) for the function '(\w+)'", text)]
        flash = [w for w in serial if "flash_wgmma_kernel" in w]
        log(f"  wgmma serialisation (C7512, C7514): {len(serial)} instantiations, "
            f"{len(flash)} of the attention program"
            + "".join(f"\n    {w}" for w in serial))
    # blocks of the attention program resident on an SM, by the occupancy query
    log("  attention program blocks an SM: " + ", ".join(
        f"<{'bias' if b else 'no bias'}, {'i8qk' if i else 'bf16'}> "
        f"{lib.caim_flash_blocks_per_sm(b, i)}" for i in (0, 1) for b in (0, 1)))
    log("  K11 clusters resident at once (a cluster of H CTAs, one a head of a 64-row tile): "
        + ", ".join(f"H {h}: {lib.caim_out_res_active_clusters(h)}" for h in range(1, 17)))
    log("  K12 clusters resident at once: " + ", ".join(
        f"K {k} F {f}: {lib.caim_attnout_mlp_active_clusters(k, f)} clusters of "
        f"{lib.caim_attnout_mlp_cluster_size(k, f)} CTAs"
        for k, f in ((768, 3072), (1024, 4096), (128, 512))))


def _rand(shape, g, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def focal_tol(ref):
    """K6's bf16 attended: TOL_FOCAL_REL of the plain version's largest value."""
    return TOL_FOCAL_REL * float(ref[0].float().abs().max())


def _flash_check(got, ref, dt):
    """K1's output against its plain version's on the inputs in f32:
    (max abs error, within tolerance, detail)."""
    import torch

    err = max_err(got, ref)
    tol = TOL_BF16_OUT if dt == torch.bfloat16 else TOL_F32_OUT
    ok = err <= tol and bool(torch.isfinite(got).all())
    return err, ok, f"max_abs_err {err:.3e} (tol {tol:.0e})"


def _focal_check(got, ref, dt):
    """K6's four outputs against its plain version's on the inputs in f32:
    (worst abs error, within tolerance, detail). The attended at focal_tol
    in bf16 and TOL_F32_OUT in f32, the three f32 views at TOL_VIEWS."""
    import torch

    errs = [max_err(a, b) for a, b in zip(got, ref)]
    tols = [focal_tol(ref) if dt == torch.bfloat16 else TOL_F32_OUT, TOL_VIEWS, TOL_VIEWS,
            TOL_VIEWS]
    ok = all(e <= t for e, t in zip(errs, tols)) and all(
        bool(torch.isfinite(t).all()) for t in got)
    names = ("attended", "colmean", "diag", "rowmax")
    return max(errs), ok, ", ".join(f"{n} {e:.3e} (tol {t:.2e})"
                                    for n, e, t in zip(names, errs, tols))


def phase_kernels():
    """K1 and K6 against their plain versions at the slice shapes."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO

    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    B, H, Dh = 8, 12, 64
    for N in (257, 416, 481, 826, 1370):  # 826 and 416: the progressive filter's streams
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (_rand((B, N, H * Dh), g, dt) for _ in range(3))
            got = FA.flash_attention_packed(q, k, v, Dh ** -0.5, H)
            ref = FA.flash_attention_packed_plain(q.float(), k.float(), v.float(),
                                                  Dh ** -0.5, H)
            torch.cuda.synchronize()
            err, ok, detail = _flash_check(got, ref, dt)
            log(f"  K1 flash_attention_packed B{B} N{N} H{H} Dh{Dh} {str(dt)[6:]}: "
                f"{detail} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version at N={N} {dt}")
            if N == 1370 and dt == torch.bfloat16:
                worst["K1"] = err

    for B, N, D, dt in ((8, 1369, 768, torch.bfloat16), (3, 77, 128, torch.bfloat16),
                        (3, 77, 128, torch.float32)):
        q, k, v = (_rand((B, N, D), g, dt, 0.5) for _ in range(3))
        scale = (D // 8) ** 0.5
        got = FO.focal_attention_fused(q, k, v, scale)
        ref = FO.focal_attention_plain(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err, ok, detail = _focal_check(got, ref, dt)
        log(f"  K6 focal_attention_fused B{B} N{N} D{D} {str(dt)[6:]}: {detail} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K6 disagrees with its plain version at N={N} {dt}")
        if N == 1369:
            worst["K6"] = err
    return worst


def phase_flash_body():
    """The bf16 attention program of K1, K7 and K8 (csrc/flash_wgmma.cu) at
    the lengths around its 64-row tiles and the model's stream lengths,
    ViT-B and ViT-L heads; and a permutation probe: V one-hot by key index
    under peaked scores, where a key moved inside a tile costs an error of
    1."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(11)
    B, Dh = 2, 64
    for H in (6, 8, 12, 16):  # 6, 8: a rank's heads of ViT-B, ViT-L at tensor parallelism 2
        worst = 0.0
        for N in FLASH_LENGTHS:
            q, k, v = (_rand((B, N, H * Dh), g, torch.bfloat16) for _ in range(3))
            ref = FA.flash_attention_packed_plain(q.float(), k.float(), v.float(), Dh ** -0.5, H)
            got = FA.flash_attention_packed(q, k, v, Dh ** -0.5, H)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if not (err <= TOL_FLASH_BF16 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"the bf16 attention program disagrees with its plain "
                                     f"version at N={N} H={H}: {err:.3e}")
            worst = max(worst, err)
        log(f"  bf16 attention program, N 1..1370 (12 lengths), H {H}: "
            f"max_abs_err {worst:.3e} (tol {TOL_FLASH_BF16:.0e}) ok")
    B, H, N = 2, 4, 257
    onehot = torch.zeros(B, N, H, Dh, device="cuda")
    j = torch.arange(N, device="cuda")
    onehot[:, j, :, j % Dh] = 1.0
    k = onehot.reshape(B, N, H * Dh).to(torch.bfloat16)
    q = (40.0 * onehot).reshape(B, N, H * Dh).to(torch.bfloat16)
    hot = (j % Dh)[None, :, None].expand(B, N, H)
    got = FA.flash_attention_packed(q, k, k, 1.0, H)
    torch.cuda.synchronize()
    ok = torch.equal(got.view(B, N, H, Dh).float().argmax(-1), hot)
    log(f"  permutation probe (one-hot V, peaked scores) N {N}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 attention program moves keys inside a tile")


def phase_f32_programs():
    """The strict policy's f32 programs against their plain versions:
    K1's (csrc/flash_f32.cuh, which K7 and K8 launch too) at the bf16
    program's lengths with ViT-B and ViT-L heads, under the permutation
    probe in f32, K7 on bias rows of zeros (bit for bit K1), an empty group
    and every key, K8 on the column slices of a fused projection (bit for
    bit K1); K6's (csrc/focal_attention.cu: the scores pass and the attend
    pass) at B8 N1369 D768, D 1024 and ragged N, on both of its block
    shapes (128 x 128 where D allows and that gives each SM a scores block,
    else 64 x 64),
    bit-identical run to run, NaN past N kept out."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO

    g = torch.Generator(device="cuda").manual_seed(14)
    worst = {"K1f32": 0.0, "K7f32": 0.0, "K8f32": 0.0, "K6f32": 0.0}
    Dh = 64

    def report(name, tag, err, tol, ok=True):
        ok = ok and err <= tol
        log(f"  {name} {tag}: max_abs_err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")
        worst[name] = max(worst[name], err)

    for H in (12, 16):
        w = 0.0
        for N in FLASH_LENGTHS:
            q, k, v = (_rand((2, N, H * Dh), g, torch.float32) for _ in range(3))
            got = FA.flash_attention_packed(q, k, v, Dh ** -0.5, H)
            ref = FA.flash_attention_packed_plain(q, k, v, Dh ** -0.5, H)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if not (err <= TOL_F32_OUT and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K1's f32 program disagrees with its plain version at "
                                     f"N={N} H={H}: {err:.3e}")
            w = max(w, err)
        report("K1f32", f"flash_attention_packed float32, N 1..1370 (12 lengths), H {H}", w,
               TOL_F32_OUT)
    B, H, N = 2, 4, 257
    onehot = torch.zeros(B, N, H, Dh, device="cuda")
    j = torch.arange(N, device="cuda")
    onehot[:, j, :, j % Dh] = 1.0
    k = onehot.reshape(B, N, H * Dh)
    got = FA.flash_attention_packed(40.0 * k, k, k, 1.0, H)
    torch.cuda.synchronize()
    ok = torch.equal(got.view(B, N, H, Dh).argmax(-1), (j % Dh)[None, :, None].expand(B, N, H))
    log(f"  f32 permutation probe (one-hot V, peaked scores) N {N}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the f32 attention program moves keys inside a tile")

    for B, H, N in ((2, 12, 257), (8, 12, 1370), (2, 16, 481)):
        scale = Dh ** -0.5
        q, k, v = (_rand((B, N, H * Dh), g, torch.float32) for _ in range(3))
        rows = _bias_rows(B, N, g)
        k1 = FA.flash_attention_packed(q, k, v, scale, H)
        for kind in ("zeros", "empty_group", "every_key"):
            got = FA.flash_attention_packed_bias(q, k, v, rows[kind], scale, H)
            ref = FA.flash_attention_packed_bias_plain(q, k, v, rows[kind], scale, H)
            torch.cuda.synchronize()
            same = kind != "zeros" or torch.equal(got, k1)
            report("K7f32", f"flash_attention_packed_bias B{B} N{N} H{H} float32 bias {kind}"
                   + (" (and bit-equal to K1)" if kind == "zeros" else ""),
                   max_err(got, ref), TOL_F32_OUT, same and bool(torch.isfinite(got).all()))
    for B, H, N in ((2, 12, 257), (8, 12, 1370), (2, 16, 257)):
        fused = _rand((B, N, 3 * H * Dh), g, torch.float32)
        views = [t.view(B, N, H, Dh) for t in fused.split(H * Dh, dim=-1)]
        got = FA.flash_attention(*views, Dh ** -0.5)
        ref = FA.attention_reference(*views, Dh ** -0.5)
        k1 = FA.flash_attention_packed(*(t.reshape(B, N, H * Dh).contiguous() for t in views),
                                       Dh ** -0.5, H)
        torch.cuda.synchronize()
        report("K8f32", f"flash_attention B{B} N{N} H{H} float32 fused slices "
               f"(token stride {3 * H * Dh}; bit-equal to K1)", max_err(got, ref), TOL_F32_OUT,
               torch.equal(got.view(B, N, H * Dh), k1))

    names = ("attended", "colmean", "diag", "rowmax")
    shapes = [(8, 1369, 768), (2, 1369, 1024)] + [
        (2, N, D) for D in (768, 1024) for N in (1, 63, 65, 256)] + [
        (3, 77, 64), (2, 129, 128), (2, 300, 512), (128, 256, 768)]
    for B, N, D in shapes:
        q, k, v = (_rand((B, N, D), g, torch.float32, 0.5) for _ in range(3))
        scale = (D // 8) ** 0.5
        got = FO.focal_attention_fused(q, k, v, scale)
        ref = FO.focal_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, ref)]
        tols = [TOL_F32_OUT, TOL_VIEWS, TOL_VIEWS, TOL_VIEWS]
        ok = all(e <= t for e, t in zip(errs, tols)) and all(
            bool(torch.isfinite(t).all()) for t in got)
        blocks = 128 if D % 128 == 0 and (-(-N // 128)) ** 2 * B >= \
            torch.cuda.get_device_properties(0).multi_processor_count else 64
        log(f"  K6f32 focal_attention_fused B{B} N{N} D{D} float32 ({blocks}-row blocks): "
            + ", ".join(f"{n} {e:.3e} (tol {t:.0e})" for n, e, t in zip(names, errs, tols))
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K6's f32 program disagrees with its plain version at "
                                 f"B{B} N{N} D{D}")
        worst["K6f32"] = max(worst["K6f32"], errs[0])
    q, k, v = (_rand((8, 1369, 768), g, torch.float32, 0.5) for _ in range(3))
    a = FO.focal_attention_fused(q, k, v, 96 ** 0.5)
    b = FO.focal_attention_fused(q, k, v, 96 ** 0.5)
    torch.cuda.synchronize()
    ok = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  K6f32 B8 N1369 D768, two runs: attended and colmean, diag, rowmax bit-identical "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K6's f32 program is not deterministic")
    N, D = 481, 256
    views = []
    for _ in range(3):
        buf = torch.full((1, N + 64, D), float("nan"), device="cuda")
        buf[:, :N] = _rand((1, N, D), g, torch.float32, 0.5)
        views.append(buf[:, :N])
    got = FO.focal_attention_fused(*views, (D // 8) ** 0.5)
    ref = FO.focal_attention_plain(*views, (D // 8) ** 0.5)
    torch.cuda.synchronize()
    ok = (all(bool(torch.isfinite(x).all()) for x in got)
          and max_err(got[0], ref[0]) <= TOL_F32_OUT
          and max(max_err(a, b) for a, b in zip(got[1:], ref[1:])) <= TOL_VIEWS)
    log(f"  K6f32 B1 N{N} D{D} float32, rows past N filled with NaN: no NaN reaches the "
        f"outputs {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K6's f32 program reads rows past N")
    return worst


def phase_i8qk_program():
    """K10, K10b and K9, the int8 instantiation of K1's program, against
    their plain versions at the lengths around its 64-row tiles and the
    model's stream lengths, ViT-B and ViT-L heads (one attention launch and
    one quantising launch a call; K10b on a zero row bit-equal to K10; K9 bit
    for bit K10 where every head of a row has the same largest value, so that
    its per-(row, head) scales are K10's joint ones; K9's quantiser Qh bit for
    bit its plain version); on rows whose every value quantises to +-127
    (integer sums up to 64 x 127^2); and under K1's permutation probe."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(13)
    B, Dh, scale = 2, 64, 0.125

    def both(q, k, v, row, sc, H):
        """{kernel: (got, plain)} for K10, K10b and K9 on the same inputs."""
        qf, kf, vf = q.float(), k.float(), v.float()
        return {"K10": (FA.flash_attention_packed_i8qk(q, k, v, sc, H),
                        FA.flash_attention_packed_i8qk_plain(qf, kf, vf, sc, H)),
                "K10b": (FA.flash_attention_packed_i8qk_bias(q, k, v, row, sc, H),
                         FA.flash_attention_packed_i8qk_bias_plain(qf, kf, vf, row, sc, H)),
                "K9": (FA.flash_attention_packed_int8(q, k, v, sc, H),
                       FA.flash_attention_packed_int8_plain(qf, kf, vf, sc, H))}

    counters = (FA.flash_attention_packed_i8qk, FA.flash_attention_packed_i8qk_bias,
                FA.quantize_rows, FA.flash_attention_packed_int8, FA.quantize_heads)
    worst_qh = 0.0
    for H in (12, 16):
        worst = {"K10": 0.0, "K10b": 0.0, "K9": 0.0}
        for N in FLASH_LENGTHS:
            q, k, v = (_rand((B, N, H * Dh), g, torch.bfloat16) for _ in range(3))
            row = torch.randint(1, 891, (B, N), generator=g, device="cuda").float().log()
            before = [w.launches for w in counters]
            outs = both(q, k, v, row, scale, H)
            after = [w.launches for w in counters]
            if [a - b for a, b in zip(after, before)] != [1, 1, 2, 1, 1]:
                raise AssertionError(f"K10, K10b, K9: one launch and one quantising launch a "
                                     f"call, counted {before} -> {after}")
            qh, qh_plain = FA.quantize_heads(q, H, k), FA.quantize_heads_plain(q, H, k)
            if not all(torch.equal(a, b) for a, b in zip(qh, qh_plain)):
                raise AssertionError(f"Qh disagrees with its plain version at N={N} H={H}")

            def rows(x8, sx):  # the dequantised rows [B, N, H, 64]
                return x8.view(B, N, H, Dh).float() * sx.transpose(1, 2)[..., None]

            worst_qh = max(worst_qh, max_err(rows(*qh[:2]), rows(*qh_plain[:2])))
            zero = FA.flash_attention_packed_i8qk_bias(q, k, v, torch.zeros(B, N, device="cuda"),
                                                       scale, H)
            torch.cuda.synchronize()
            if not torch.equal(zero, outs["K10"][0]):
                raise AssertionError(f"K10b on a zero row is not K10's bits at N={N} H={H}")
            for name, (got, ref) in outs.items():
                err = max_err(got, ref)
                if not (err <= TOL_BF16_OUT and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"{name} disagrees with its plain version at N={N} "
                                         f"H={H}: {err:.3e}")
                worst[name] = max(worst[name], err)
        log(f"  int8 attention program, N 1..1370 (12 lengths), H {H}: max_abs_err K10 "
            f"{worst['K10']:.3e}, K10b {worst['K10b']:.3e}, K9 {worst['K9']:.3e} (tol "
            f"{TOL_BF16_OUT:.0e}); K10b on a zero row equals K10 bit for bit; Qh (K9's "
            f"quantiser) equals its plain version bit for bit; 1 launch + 1 quantising launch "
            f"a call: ok")
    # K9 on rows whose every head has the same largest value: its (row, head)
    # scales are K10's joint-row scales, so it gives K10's bits
    for H, N in ((12, 481), (12, 1370), (16, 257)):
        q, k, v = (_rand((B, N, H * Dh), g, torch.bfloat16, 0.5) for _ in range(3))
        for t in (q, k):
            t.view(B, N, H, Dh)[..., 5] = 3.0  # each head's largest |value|
        got9, got10 = (FA.flash_attention_packed_int8(q, k, v, scale, H),
                       FA.flash_attention_packed_i8qk(q, k, v, scale, H))
        torch.cuda.synchronize()
        if not torch.equal(got9, got10):
            raise AssertionError(f"K9 on equal head maxima is not K10's bits at N={N} H={H}")
    log("  K9 on rows whose heads share their largest value equals K10 bit for bit "
        "(N 481, 1370 at H 12; N 257 at H 16): ok")
    errs = {"Qh": worst_qh}
    # every value at +-127 after quantisation: sums up to 64 x 127^2 < 2^24
    H = 12
    for N in (481, 1370):
        sign = lambda: torch.where(torch.rand(B, N, H * Dh, generator=g, device="cuda") < 0.5,
                                   -1.0, 1.0).to(torch.bfloat16)
        q, k = sign(), sign()
        v = _rand((B, N, H * Dh), g, torch.bfloat16)
        if not bool((FA.quantize_rows(q)[0].abs() == 127).all()):
            raise AssertionError("rows of +-1 must quantise to +-127")
        for name, (got, ref) in both(q, k, v, _bias_rows(B, N, g)["counts"], scale, H).items():
            torch.cuda.synchronize()
            err = max_err(got, ref)
            ok = err <= TOL_BF16_OUT
            log(f"  {name} rows of +-127 N {N}: max_abs_err {err:.3e} (tol {TOL_BF16_OUT:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version on rows of +-127")
    # the permutation probe: V one-hot by key index, q = 40 k
    H, N = 4, 257
    onehot = torch.zeros(B, N, H, Dh, device="cuda")
    j = torch.arange(N, device="cuda")
    onehot[:, j, :, j % Dh] = 1.0
    k = onehot.reshape(B, N, H * Dh).to(torch.bfloat16)
    q = (40.0 * onehot).reshape(B, N, H * Dh).to(torch.bfloat16)
    hot = (j % Dh)[None, :, None].expand(B, N, H)
    for name, (got, _) in both(q, k, k, torch.zeros(B, N, device="cuda"), 1.0, H).items():
        torch.cuda.synchronize()
        ok = torch.equal(got.view(B, N, H, Dh).float().argmax(-1), hot)
        log(f"  {name} permutation probe (one-hot V, peaked scores) N {N}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: the int8 attention program moves keys inside a tile")
    return errs


def _bias_rows(B, N, g):
    """name -> f32 [B, N] key-side logit bias rows of the kinds the token
    filter makes: zeros; log of token counts (up to 890) on the 4 trailing
    context tokens; the same with one empty group at log(1e-6); and, to
    reach every column of the staged row, log counts on every key."""
    import math

    import torch

    def counts(*shape):
        return torch.randint(1, 891, shape, generator=g, device="cuda").float().log()

    tail = torch.zeros(B, N, device="cuda")
    tail[:, -4:] = counts(B, 4)
    empty = tail.clone()
    empty[:, -2] = math.log(1e-6)
    return {"zeros": torch.zeros(B, N, device="cuda"), "counts": tail,
            "empty_group": empty, "every_key": counts(B, N)}


def phase_filter_kernels():
    """K7, K10 and K10b against their plain versions: the filtered slices'
    N 481 and 416, the unfiltered 1370, the ragged 257, ViT-L
    width; bf16, K7 also in float32."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(8)
    worst = {"K7": 0.0, "K10": 0.0, "K10b": 0.0}
    Dh = 64

    def check(name, tag, got, ref, tol, main):
        torch.cuda.synchronize()
        err = max_err(got, ref)
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"  {name} {tag}: max_abs_err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")
        if main:
            worst[name] = max(worst[name], err)

    for B, H, N in ((8, 12, 481), (8, 12, 1370), (8, 12, 257), (8, 12, 416), (2, 16, 257)):
        main = H == 12 and N in (481, 1370)
        scale = Dh ** -0.5
        q, k, v = (_rand((B, N, H * Dh), g, torch.bfloat16) for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        rows = _bias_rows(B, N, g)
        shape = f"B{B} N{N} H{H}"
        check("K10", f"flash_attention_packed_i8qk {shape} bf16",
              FA.flash_attention_packed_i8qk(q, k, v, scale, H),
              FA.flash_attention_packed_i8qk_plain(qf, kf, vf, scale, H), TOL_BF16_OUT, main)
        k1 = FA.flash_attention_packed(q, k, v, scale, H)
        for kind, bias in rows.items():
            got = FA.flash_attention_packed_bias(q, k, v, bias, scale, H)
            check("K7", f"flash_attention_packed_bias {shape} bf16 bias {kind}", got,
                  FA.flash_attention_packed_bias_plain(qf, kf, vf, bias, scale, H),
                  TOL_BF16_OUT, main)
            got8 = FA.flash_attention_packed_i8qk_bias(q, k, v, bias, scale, H)
            check("K10b", f"flash_attention_packed_i8qk_bias {shape} bf16 bias {kind}", got8,
                  FA.flash_attention_packed_i8qk_bias_plain(qf, kf, vf, bias, scale, H),
                  TOL_BF16_OUT, main)
            if kind == "zeros":  # a zero bias is K1 / K10
                check("K7", f"zero bias against the K1 kernel {shape}", got, k1,
                      TOL_BF16_OUT, False)
                k10 = FA.flash_attention_packed_i8qk(q, k, v, scale, H)
                torch.cuda.synchronize()
                log(f"  K10b zero bias against the K10 kernel {shape}: bit for bit "
                    f"{torch.equal(got8, k10)}")
                if not torch.equal(got8, k10):
                    raise AssertionError("K10b on a zero bias row is not K10's bits")
        if N in (257, 481):  # the strict policy's kernel
            for kind in ("zeros", "empty_group", "every_key"):
                check("K7", f"flash_attention_packed_bias {shape} float32 bias {kind}",
                      FA.flash_attention_packed_bias(qf, kf, vf, rows[kind], scale, H),
                      FA.flash_attention_packed_bias_plain(qf, kf, vf, rows[kind], scale, H),
                      TOL_F32_OUT, False)
    # quantize_rows: both sides divide, round half to even and clip in f32, so
    # the int8 values and the scales are equal bit for bit
    worst["Q"] = 0.0
    for B, N, D in ((8, 481, 768), (8, 1370, 768), (2, 257, 1024)):
        x = _rand((B, N, D), g, torch.bfloat16, 2.0)
        (x8, sx), (p8, ps) = FA.quantize_rows(x), FA.quantize_rows_plain(x)
        torch.cuda.synchronize()
        err = max_err(x8.float() * sx, p8.float() * ps)
        ok = torch.equal(x8, p8) and torch.equal(sx, ps)
        log(f"  Q quantize_rows B{B} N{N} D{D} bf16: int8 values and f32 scales equal the "
            f"plain version's: {ok}; max_abs_err of the dequantised rows {err:.3e} (tol 0)")
        if not ok:
            raise AssertionError("quantize_rows disagrees with its plain version")
        worst["Q"] = max(worst["Q"], err)
        y = _rand((B, N, D), g, torch.bfloat16, 0.5)
        n = FA.quantize_rows.launches
        pair = FA.quantize_rows(x, y)
        ok = FA.quantize_rows.launches == n + 1 and all(
            torch.equal(a, b) for a, b in zip(pair, FA.quantize_rows_plain(x, y)))
        torch.cuda.synchronize()
        log(f"  Q quantize_rows of two tensors (K10's q and k) B{B} N{N} D{D}: one launch, "
            f"both equal the plain version's: {ok}")
        if not ok:
            raise AssertionError("quantize_rows of two tensors disagrees with its plain version")
    return worst


# ------------------------------------------------------- int8 kernels (c) ----
def _int8_inputs(B, N, D, F, g):
    """Seeded inputs of one transformer block's int8 kernels: bf16
    activations, int8 weights with f32 scales, and f32 vectors holding
    bf16-rounded values, as ``prepare_params`` leaves them."""
    import torch

    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight
    from cognitive_aim_tpu_torch.nn.layers import round_through

    def vec(n, scale, shift=0.0):
        return round_through(_rand((n,), g, torch.float32, scale) + shift, torch.bfloat16)

    t = {"x": _rand((B, N, D), g, torch.bfloat16), "ctx": _rand((B, N, D), g, torch.bfloat16),
         "gamma": vec(D, 0.1, 1.0), "beta": vec(D, 0.05), "ls": vec(D, 0.1, 0.9),
         "ls2": vec(D, 0.1, 0.8)}
    for name, n, k in (("qkv", 3 * D, D), ("out", D, D), ("fc1", F, D), ("fc2", D, F)):
        w = quantize_weight(_rand((n, k), g, torch.float32, 0.05))
        t[name] = (w["q"], w["s"], vec(n, 0.01))
    return t


def _int8_calls(t, eps=1e-6):
    """name -> (wrapper call, plain call) of each int8 kernel on inputs t;
    K4b reads the plain K4a's int8 hidden on both sides."""
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    x, ctx, ga, be, ls = t["x"], t["ctx"], t["gamma"], t["beta"], t["ls"]
    h8, sh = IB.int8_fc1_gelu_ln_plain(x, ga, be, *t["fc1"], eps)
    return {
        "K2": (lambda: IB.int8_qkv_proj_ln(x, ga, be, *t["qkv"], eps),
               lambda: IB.int8_qkv_proj_ln_plain(x, ga, be, *t["qkv"], eps).unbind(0)),
        "K5": (lambda: IB.int8_qkv_proj(x, *t["qkv"]),
               lambda: IB.int8_qkv_proj_plain(x, *t["qkv"]).unbind(0)),
        "K3": (lambda: IB.int8_out_residual(ctx, *t["out"], ls, x),
               lambda: IB.int8_out_residual_plain(ctx, *t["out"], ls, x)),
        "K4a": (lambda: IB.int8_fc1_gelu_ln(x, ga, be, *t["fc1"], eps),
                lambda: IB.int8_fc1_gelu_ln_plain(x, ga, be, *t["fc1"], eps)),
        "K4b": (lambda: IB.int8_out_residual_prequant(h8, sh, *t["fc2"], ls, x),
                lambda: IB.int8_out_residual_prequant_plain(h8, sh, *t["fc2"], ls, x)),
        "K4": (lambda: IB.int8_mlp_ln(x, ga, be, *t["fc1"], *t["fc2"], ls, eps),
               lambda: IB.int8_mlp_ln_plain(x, ga, be, *t["fc1"], *t["fc2"], ls, eps)),
    }


def _int8_check(name, got, want):
    """An int8 kernel's output against its plain version's: (max abs error,
    within tolerance, detail). K4a: its int8 hidden and row scales, the error
    of the dequantised hidden; the others (K12 too): TOL_INT8_REL of the
    plain output's largest value (at least 1)."""
    import torch

    if name == "K4a":
        (h8, sh), (h8p, shp) = got, want
        diff = (h8.int() - h8p.int()).abs()
        share, worst = float((diff > 0).float().mean()), int(diff.max())
        srel = (sh - shp).abs() / shp
        srows, sworst = float((srel > TOL_INT8_SCALE).float().mean()), float(srel.max())
        ok = (share < TOL_INT8_SHARE and worst <= 1
              and srows < TOL_INT8_SCALE_ROWS and sworst <= TOL_INT8_SCALE_WORST)
        return max_err(h8.float() * sh, h8p.float() * shp), ok, (
            f"int8 differ {share:.2e} (tol {TOL_INT8_SHARE:.0e}) by at most "
            f"{worst} (tol 1), scales rel > {TOL_INT8_SCALE:.0e} in {srows:.2e} of "
            f"rows (tol {TOL_INT8_SCALE_ROWS:.0e}), worst {sworst:.2e} "
            f"(tol {TOL_INT8_SCALE_WORST:.0e})")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_err(a, b) for a, b in zip(got, want))
    lim = TOL_INT8_REL * max(1.0, max(float(b.float().abs().max()) for b in want))
    ok = err <= lim and all(a.is_contiguous() and bool(torch.isfinite(a).all()) for a in got)
    return err, ok, f"max_abs_err {err:.3e} (tol {lim:.2e})"


def _check_int8_case(tag, t):
    """Every int8 kernel against its plain version on inputs t; returns
    name -> max abs error (K4a: of the dequantised hidden)."""
    import torch

    errs = {}
    for name, (kernel, plain) in _int8_calls(t).items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs[name], ok, detail = _int8_check(name, got, want)
        log(f"  {name} {tag}: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")
    return errs


def phase_int8_kernels():
    """K2, K3, K4a, K4b, K4, K5 against their plain versions: the slice
    shape, the ragged N 257 and 481, and ViT-L widths."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(6)
    errs = _check_int8_case("B8 N1370 D768 F3072", _int8_inputs(8, 1370, 768, 3072, g))
    errs["K5"] = _check_int8_case("B8 N1369 D768 F3072",
                                  _int8_inputs(8, 1369, 768, 3072, g))["K5"]
    for B, N, D, F in ((8, 257, 768, 3072), (8, 481, 768, 3072), (2, 257, 1024, 4096)):
        _check_int8_case(f"B{B} N{N} D{D} F{F}", _int8_inputs(B, N, D, F, g))
    return errs


# ------------------------------------------ the int8 GEMM's program (c) ----
def phase_int8_gemm():
    """The GEMM program of K2, K5, K3, K4b, K13 and K15 (csrc/int8_block.cu,
    int8_gemm_tma_kernel): its width rule against the
    wrappers' (int8_block.gemm_tile_cols), every epilogue against its plain
    version at each tile width and at M 10960, 8 x 481, 8 x 257, 17 and 1
    rows, tile counts under, at and over its resident CTAs, outputs that are
    the first M rows of a larger buffer (the TMA stores write none past M),
    and one GEMM launch a call after the prologue."""
    import torch

    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG
    from cognitive_aim_tpu_torch.kernels._launch import ptr, stream_of

    g = torch.Generator(device="cuda").manual_seed(13)
    lib = _build.library()

    def report(name, tag, ok, detail=""):
        log(f"  {name} {tag}{': ' + detail if detail else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in (10960, 10952, 3848, 2056, 17, 1):
        for N in range(0, 8193, 32):
            for parts in (1, 3):
                want = IB.gemm_tile_cols(M, N, parts, sms) or 0
                if lib.caim_gemm_tile_cols(M, N, parts, sms) != want:
                    raise AssertionError(f"GEMM width rule: C and Python differ at M {M} N {N}")
    log(f"  GEMM width rule: C and Python agree at N 0..8192, 1 and 3 parts, six row counts; "
        f"{sms} SMs; resident CTAs {lib.caim_gemm_resident_ctas(192)} (192 columns), "
        f"{lib.caim_gemm_resident_ctas(128)} (128)")

    def cases(t, M):
        x, ctx, ga, be, ls = t["x"], t["ctx"], t["gamma"], t["beta"], t["ls"]
        x2, D = x.view(M, -1), x.shape[-1]
        h8, sh = IB.int8_fc1_gelu_ln_plain(x, ga, be, *t["fc1"])
        return {  # name: (kernel, plain, bit-equal?, [M, N, parts] of its GEMM)
            "K2": (lambda: IB.int8_qkv_proj_ln(x, ga, be, *t["qkv"]),
                   lambda: IB.int8_qkv_proj_ln_plain(x, ga, be, *t["qkv"]).unbind(0), False,
                   (3 * D, 3)),
            "K5": (lambda: IB.int8_qkv_proj(x, *t["qkv"]),
                   lambda: IB.int8_qkv_proj_plain(x, *t["qkv"]).unbind(0), True, (3 * D, 3)),
            "K3": (lambda: IB.int8_out_residual(ctx, *t["out"], ls, x),
                   lambda: IB.int8_out_residual_plain(ctx, *t["out"], ls, x), True, (D, 1)),
            "K4b": (lambda: IB.int8_out_residual_prequant(h8, sh, *t["fc2"], ls, x),
                    lambda: IB.int8_out_residual_prequant_plain(h8, sh, *t["fc2"], ls, x), True,
                    (D, 1)),
            "K13": (lambda: IB.int8_proj(x, *t["fc1"]), lambda: IB.int8_proj_plain(x, *t["fc1"]),
                    True, (t["fc1"][0].shape[0], 1)),
            "K15": (lambda: IG.int8_gemm_fused(x2, *t["qkv"]),
                    lambda: IG.int8_gemm_fused_plain(x2, *t["qkv"]), True, (3 * D, 1)),
        }

    for D, F in ((768, 3072), (1024, 4096), (128, 512)):
        for M in (10960, 8 * 481, 8 * 257, 17, 1):
            t = _int8_inputs(1, M, D, F, g)
            for name, (kern, plain, exact, (Nout, parts)) in cases(t, M).items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                cols = IB.gemm_tile_cols(M, Nout, parts, sms)
                tag = f"GEMM M{M} D{D} F{F}, tiles of 128 x {cols}"
                if exact:
                    report(name, tag, all(torch.equal(a, b) for a, b in zip(got, want)),
                           "bit-equal to the plain version")
                else:
                    err = max(max_err(a, b) for a, b in zip(got, want))
                    lim = TOL_INT8_REL * max(1.0, max(float(b.float().abs().max())
                                                      for b in want))
                    report(name, tag, err <= lim, f"max_abs_err {err:.3e} (tol {lim:.2e})")
    # tile counts under, at and over the resident CTAs (N 128: one column tile)
    R = lib.caim_gemm_resident_ctas(128)
    for M in (128 * (R - 1) - 5, 128 * R, 128 * R + 1, 128 * 2 * R + 77):
        x, w, b = _proj_inputs((M,), 256, 128, g)
        got, want = IG.int8_gemm_fused(x, w["q"], w["s"], b), IG.int8_gemm_fused_plain(
            x, w["q"], w["s"], b)
        torch.cuda.synchronize()
        report("K15", f"M{M} K256 -> 128: {-(-M // 128)} tiles for {R} resident CTAs",
               torch.equal(got, want), "bit-equal to the plain version")
    # outputs that are the first M rows of a larger buffer, and q, k, v followed
    # by more memory: nothing past M is written
    sentinel = -3.0e38
    for D, M in ((768, 10960), (1024, 3848), (128, 17)):
        t = _int8_inputs(1, M, D, 4 * D, g)
        x, ctx = t["x"].view(M, D), t["ctx"].view(M, D)
        xq, sx = IB.quantize_activations(ctx.float())
        sx = sx.contiguous()
        wq, ws, b = t["out"]
        big = torch.full((M + 200, D), sentinel, device="cuda", dtype=torch.bfloat16)
        err = lib.caim_int8_out_residual(None, ptr(xq), ptr(sx), ptr(wq), ptr(ws), ptr(b),
                                         ptr(t["ls"]), ptr(x), ptr(big), M, D, D, stream_of(x))
        torch.cuda.synchronize()
        want = IB.int8_out_residual_prequant_plain(xq, sx, wq, ws, b, t["ls"], x)
        report("K4b", f"M{M} D{D} into the first M rows of M + 200",
               err == 0 and torch.equal(big[:M], want) and bool((big[M:] == big[-1]).all())
               and float(big[-1, 0]) < -1e38, "rows past M untouched")
        wq, ws, b = t["qkv"]
        buf = torch.full((3 * M * D + 4096,), sentinel, device="cuda", dtype=torch.bfloat16)
        scratch = torch.empty_like(xq), torch.empty_like(sx)
        err = lib.caim_int8_qkv(ptr(x), None, None, 0.0, ptr(wq), ptr(ws), ptr(b), ptr(buf),
                                ptr(scratch[0]), ptr(scratch[1]), M, D, stream_of(x))
        torch.cuda.synchronize()
        want = IB.int8_qkv_proj_plain(x, wq, ws, b)
        ok = err == 0 and all(torch.equal(buf[i * M * D:(i + 1) * M * D].view(M, D), want[i])
                              for i in range(3))
        report("K5", f"M{M} D{D} q, k, v followed by 4096 more elements",
               ok and bool((buf[3 * M * D:] == buf[-1]).all()) and float(buf[-1]) < -1e38,
               "memory past v untouched")
    # one GEMM launch a call, after the prologue where there is one
    t = _int8_inputs(8, 1370, 768, 3072, g)
    for name, (kern, _, _, _) in cases(t, 8 * 1370).items():
        names = [n.split("(")[0] for n in device_kernels(kern)]
        gemms = [n for n in names if "int8_gemm_tma_kernel" in n]
        log(f"  {name}: device kernels a call: {', '.join(names)}")
        if len(gemms) != 1 or names[-1] != gemms[0] or "int8_gemm_kernel<" in " ".join(names):
            raise AssertionError(f"{name} must launch one GEMM a call, after its prologue")


def _proj_inputs(M_shape, K, Nout, g):
    """bf16 rows [*M_shape, K], an int8 weight [Nout, K] with f32 scales, and
    an f32 bias holding bf16-rounded values."""
    import torch

    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight
    from cognitive_aim_tpu_torch.nn.layers import round_through

    x = _rand((*M_shape, K), g, torch.bfloat16)
    w = quantize_weight(_rand((Nout, K), g, torch.float32, 0.05))
    b = round_through(_rand((Nout,), g, torch.float32, 0.01), torch.bfloat16)
    return x, w, b


def phase_adapter_kernels():
    """K8, K13, K14 and K15 against their plain versions."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG

    g = torch.Generator(device="cuda").manual_seed(9)
    worst = {"K8": 0.0, "K13": 0.0, "K14": 0.0, "K15": 0.0}
    Dh = 64

    def report(name, tag, err, tol, ok, main=True):
        log(f"  {name} {tag}: max_abs_err {err:.3e} (tol {tol:.2e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")
        if main:
            worst[name] = max(worst[name], err)

    # K8: separately made tensors, and the three column slices of one fused
    # projection read in place; the same bits as K1 on the packed layout
    for B, H, N in ((8, 12, 1370), (8, 12, 481), (8, 12, 257), (2, 16, 257)):
        for dt, tol in ((torch.bfloat16, TOL_BF16_OUT), (torch.float32, TOL_F32_OUT)):
            fused = _rand((B, N, 3 * H * Dh), g, dt)
            views = [t.view(B, N, H, Dh) for t in fused.split(H * Dh, dim=-1)]
            for layout, (q, k, v) in (("fused slices", views),
                                      ("contiguous", [t.contiguous() for t in views])):
                got = FA.flash_attention(q, k, v, Dh ** -0.5)
                ref = FA.attention_reference(q.float(), k.float(), v.float(), Dh ** -0.5)
                packed = (t.reshape(B, N, H * Dh).contiguous() for t in (q, k, v))
                k1 = FA.flash_attention_packed(*packed, Dh ** -0.5, H)
                torch.cuda.synchronize()
                err = max_err(got, ref)
                ok = (err <= tol and bool(torch.isfinite(got).all()) and got.is_contiguous()
                      and torch.equal(got.view(B, N, H * Dh), k1))
                report("K8", f"flash_attention B{B} N{N} H{H} {str(dt)[6:]} {layout} "
                       f"(and bit-equal to K1)", err, tol, ok,
                       main=N == 1370 and dt == torch.bfloat16)

    def lim(want):
        return TOL_INT8_REL * max(1.0, float(want.float().abs().max()))

    # K13 at a block's projection shapes (fc2: rows 3072 wide), ViT-L widths, ragged N
    for B, N, K, Nout in ((8, 1370, 768, 768), (8, 1370, 768, 3072), (8, 1370, 3072, 768),
                          (8, 1370, 768, 2304), (2, 257, 1024, 4096), (2, 257, 4096, 1024),
                          (8, 257, 768, 768), (8, 481, 3072, 768)):
        x, w, b = _proj_inputs((B, N), K, Nout, g)
        got, want = IB.int8_proj(x, w["q"], w["s"], b), IB.int8_proj_plain(x, w["q"], w["s"], b)
        torch.cuda.synchronize()
        err = max_err(got, want)
        report("K13", f"int8_proj B{B} N{N} K{K} -> {Nout}", err, lim(want),
               err <= lim(want) and got.is_contiguous() and got.shape == (B, N, Nout),
               main=B == 8 and N == 1370)
    # K15 on flattened rows, and over leading dimensions
    for M, K, Nout in ((8 * 1370, 768, 2304), (8 * 481, 768, 2304), (2 * 257, 1024, 3072)):
        x, w, b = _proj_inputs((M,), K, Nout, g)
        got = IG.int8_gemm_fused(x, w["q"], w["s"], b)
        want = IG.int8_gemm_fused_plain(x, w["q"], w["s"], b)
        lead = IG.int8_linear_fused(x.view(2, M // 2, K), w, b)
        torch.cuda.synchronize()
        err = max_err(got, want)
        report("K15", f"int8_gemm_fused M{M} K{K} -> {Nout}", err, lim(want),
               err <= lim(want) and torch.equal(lead.view(M, Nout), got), main=M == 8 * 1370)
    # K14 against its plain version, and against K4a on layernormed rows
    for B, N, D, F in ((8, 1370, 768, 3072), (8, 481, 768, 3072), (2, 257, 1024, 4096)):
        t = _int8_inputs(B, N, D, F, g)
        (h8, sh), (h8p, shp) = IB.int8_fc1_gelu(t["x"], *t["fc1"]), \
            IB.int8_fc1_gelu_plain(t["x"], *t["fc1"])
        torch.cuda.synchronize()
        diff = (h8.int() - h8p.int()).abs()
        share, most = float((diff > 0).float().mean()), int(diff.max())
        srel = float(((sh - shp).abs() / shp).max())
        err = max_err(h8.float() * sh, h8p.float() * shp)
        ok = share < TOL_INT8_SHARE and most <= 1 and srel <= TOL_INT8_SCALE
        log(f"  K14 int8_fc1_gelu B{B} N{N} D{D} F{F}: int8 differ {share:.2e} (tol "
            f"{TOL_INT8_SHARE:.0e}) by at most {most} (tol 1), scales rel {srel:.2e} (tol "
            f"{TOL_INT8_SCALE:.0e}), dequantised max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K14 disagrees with its plain version")
        if N == 1370:
            worst["K14"] = err
        normed = IB._ln_f32(t["x"].float(), t["gamma"], t["beta"], 1e-6).to(torch.bfloat16)
        a8, sa = IB.int8_fc1_gelu(normed, *t["fc1"])
        b8, sb = IB.int8_fc1_gelu_ln(t["x"], t["gamma"], t["beta"], *t["fc1"], 1e-6)
        torch.cuda.synchronize()
        err = max_err(a8.float() * sa, b8.float() * sb)
        tol = TOL_K14_NORMED * float((b8.float() * sb).abs().max())
        report("K14", f"int8_fc1_gelu on layernormed rows against K4a B{B} N{N} D{D} F{F} "
               f"(int8 differ {float((a8 != b8).float().mean()):.2e})", err, tol, err <= tol,
               main=False)
    return worst


def _k12_calls(t, eps=1e-6):
    """(K12 wrapper call, its plain version, K3 then K4 through their
    wrappers) on the inputs of ``_int8_inputs``."""
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    args = (t["ctx"], *t["out"], t["ls"], t["x"], t["gamma"], t["beta"], *t["fc1"], *t["fc2"],
            t["ls2"], eps)

    def split():
        x = IB.int8_out_residual(t["ctx"], *t["out"], t["ls"], t["x"])
        return IB.int8_mlp_ln(x, t["gamma"], t["beta"], *t["fc1"], *t["fc2"], t["ls2"], eps)

    return (lambda: IB.int8_attnout_mlp_ln(*args),
            lambda: IB.int8_attnout_mlp_ln_plain(*args), split)


def _k11_inputs(B, N, H, g):
    """q, k, v bf16 [B, N, H*64]; the attn_out weight int8 [HD, HD] with f32
    scales; bias and LayerScale f32 at bf16-rounded values; the residual."""
    import torch

    from cognitive_aim_tpu_torch.nn.layers import round_through

    HD = H * 64
    q, k, v, res = (_rand((B, N, HD), g, torch.bfloat16) for _ in range(4))
    _, w, b = _proj_inputs((1,), HD, HD, g)
    ls = round_through(_rand((HD,), g, torch.float32, 0.1) + 0.9, torch.bfloat16)
    return q, k, v, w["q"], w["s"], b, ls, res


def phase_fused_kernels():
    """K9, K11 and K12 against their plain versions at the slice's shape, the
    ragged N 481 and 257 and ViT-L widths; K12 also against K3 -> K4; what each
    raises on."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    g = torch.Generator(device="cuda").manual_seed(10)
    worst = {"K9": 0.0, "K11": 0.0, "K12": 0.0}

    def report(name, tag, detail, ok):
        log(f"  {name} {tag}: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")

    def expect_raise(name, kind, wrapper, call):
        n = wrapper.launches
        try:
            call()
        except kind:
            if wrapper.launches != n:
                raise AssertionError(f"{name} counted a launch that raised")
            return
        raise AssertionError(f"{name} took what its kernel does not take")

    # K12 against its plain version, and against K3 -> K4 (which rounds the
    # post-attention residual to bf16: not the same bits, the same values)
    for B, N, D, F in ((8, 1370, 768, 3072), (8, 481, 768, 3072), (8, 257, 768, 3072),
                       (2, 257, 1024, 4096)):
        t = _int8_inputs(B, N, D, F, g)
        kernel, plain, split = _k12_calls(t)
        counts = [w.launches for w in IB.WRAPPERS if w is not IB.int8_attnout_mlp_ln]
        got = kernel()
        if [w.launches for w in IB.WRAPPERS if w is not IB.int8_attnout_mlp_ln] != counts:
            raise AssertionError("K12 counted a launch of another wrapper")
        want, two = plain(), split()
        torch.cuda.synchronize()
        err, lim = max_err(got, want), TOL_INT8_REL * max(1.0, float(want.float().abs().max()))
        gap, gap_lim = max_err(got, two), TOL_K12_SPLIT * max(1.0, float(two.float().abs().max()))
        same = float((got == two).float().mean())
        ok = (err <= lim and gap <= gap_lim and not torch.equal(got, two)
              and got.is_contiguous() and bool(torch.isfinite(got).all()))
        report("K12", f"int8_attnout_mlp_ln B{B} N{N} D{D} F{F}",
               f"max_abs_err {err:.3e} (tol {lim:.2e}); against K3 -> K4 {gap:.3e} (tol "
               f"{gap_lim:.2e}), {1 - same:.2e} of the outputs differ (must not be 0)", ok)
        if N == 1370:
            worst["K12"] = err
    x = _int8_inputs(2, 70, 128, 512, g)
    for name, change in (("float32 activations", {"ctx": x["ctx"].float()}),
                         ("a transposed residual",
                          {"x": x["x"].transpose(0, 1).contiguous().transpose(0, 1)})):
        expect_raise(f"K12 on {name}", (TypeError, ValueError), IB.int8_attnout_mlp_ln,
                     _k12_calls({**x, **change})[0])
    for D, F in ((2048, 2048), (256, 512), (768, 4096)):  # no instantiation takes these
        expect_raise(f"K12 at widths {D}, {F}", ValueError, IB.int8_attnout_mlp_ln,
                     _k12_calls(_int8_inputs(1, 8, D, F, g))[0])

    Dh = 64
    for B, H, N in ((8, 12, 1370), (8, 12, 481), (8, 12, 257), (2, 16, 257)):
        scale, shape = Dh ** -0.5, f"B{B} N{N} H{H} bf16"
        q, k, v = (_rand((B, N, H * Dh), g, torch.bfloat16) for _ in range(3))
        n1, n9 = FA.flash_attention_packed.launches, FA.flash_attention_packed_int8.launches
        got = FA.flash_attention_packed(q, k, v, scale, H, int8_dots=True)
        if (FA.flash_attention_packed.launches, FA.flash_attention_packed_int8.launches) \
                != (n1, n9 + 1):
            raise AssertionError("int8_dots=True must launch K9 and count there only")
        want = FA.flash_attention_packed_int8_plain(q.float(), k.float(), v.float(), scale, H)
        torch.cuda.synchronize()
        err = max_err(got, want)
        report("K9", f"flash_attention_packed(int8_dots=True) {shape}",
               f"max_abs_err {err:.3e} (tol {TOL_BF16_OUT:.0e})",
               err <= TOL_BF16_OUT and bool(torch.isfinite(got).all()))
        if N == 1370:
            worst["K9"] = err
    z = torch.zeros(2, 70, 128, device="cuda", dtype=torch.bfloat16)
    got = FA.flash_attention_packed_int8(z, z, z + 1, 0.125, 2)  # zero heads: the scale floor
    torch.cuda.synchronize()
    if not torch.equal(got, z + 1):
        raise AssertionError("K9 on all-zero q and k must average v")
    expect_raise("K9 on float32", TypeError, FA.flash_attention_packed_int8,
                 lambda: FA.flash_attention_packed_int8(z.float(), z.float(), z.float(), 0.1, 2))
    expect_raise("K9 on a strided q", ValueError, FA.flash_attention_packed_int8,
                 lambda: FA.flash_attention_packed_int8(z.repeat(1, 1, 2)[..., :128], z, z, 0.1, 2))

    # K11: the kernel rounds the un-normalised P to bf16 (as K1), the plain
    # version the normalised P, so the f32 contexts differ by ~1e-3 relative and
    # a share of the int8 context values lands one step apart
    for B, H, N in ((8, 12, 1370), (8, 12, 481), (8, 12, 257), (2, 16, 257)):
        scale, shape = Dh ** -0.5, f"B{B} N{N} H{H} bf16"
        args = _k11_inputs(B, N, H, g)
        got, c8, sc = FA.flash_attention_packed_out_res(*args, scale, H, return_quantised=True)
        want = FA.flash_attention_packed_out_res_plain(*args, scale, H)
        p8, ps = IB.quantize_activations(FA.attention_context_f32(*args[:3], scale, H))
        again = FA.flash_attention_packed_out_res(*args, scale, H)
        torch.cuda.synchronize()
        diff = (c8.int() - p8.int()).abs()
        share, most = float((diff > 0).float().mean()), int(diff.max())
        srel = float(((sc - ps).abs() / ps).max())
        err, lim = max_err(got, want), TOL_INT8_REL * max(1.0, float(want.float().abs().max()))
        ok = (err <= lim and share <= TOL_K11_CTX_SHARE and most <= 1
              and srel <= TOL_K11_SCALE and torch.equal(got, again)
              and bool(torch.isfinite(got).all()))
        report("K11", f"flash_attention_packed_out_res {shape}",
               f"max_abs_err {err:.3e} (tol {lim:.2e}); int8 context differs in {share:.2e} "
               f"(tol {TOL_K11_CTX_SHARE:.0e}) by at most {most} (tol 1), scales rel "
               f"{srel:.2e} (tol {TOL_K11_SCALE:.0e})", ok)
        if N == 1370:
            worst["K11"] = err
    a = _k11_inputs(1, 8, 17, g)  # 17 heads: more CTAs than a cluster takes
    expect_raise("K11 with 17 heads", ValueError, FA.flash_attention_packed_out_res,
                 lambda: FA.flash_attention_packed_out_res(*a, 0.125, 17))
    a = _k11_inputs(2, 70, 2, g)
    expect_raise("K11 with a scale of 0", ValueError, FA.flash_attention_packed_out_res,
                 lambda: FA.flash_attention_packed_out_res(*a, 0.0, 2))
    expect_raise("K11 on a float32 residual", TypeError, FA.flash_attention_packed_out_res,
                 lambda: FA.flash_attention_packed_out_res(*a[:-1], a[-1].float(), 0.125, 2))
    return worst


def phase_k12_kernel():
    """K12's one kernel (csrc/int8_fused_block.cu: a thread-block cluster owns
    a 64-row tile across all of its columns): its shape rule equal to the
    wrappers' (int8_block.attnout_mlp_shape); against its plain version and
    against K3 -> K4, which it must not equal, at M 10960, 8 x 481, 8 x 257,
    17 and 1 rows and ViT-B, ViT-L and the tests' widths, with rows of zeros
    in ctx and the residual; one device kernel a call."""
    import torch

    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    g = torch.Generator(device="cuda").manual_seed(12)
    lib = _build.library()
    for K in range(0, 2049, 64):
        for F in range(0, 8193, 128):
            if lib.caim_attnout_mlp_cluster_size(K, F) != (IB.attnout_mlp_shape(K, F) or (0,))[0]:
                raise AssertionError(f"K12 shape rule: C and Python differ at K {K} F {F}")
    log(f"  K12 shape rule: C and Python agree at K 0..2048, F 0..8192; it takes "
        f"{sorted(IB.ATTNOUT_MLP_SHAPES)}")
    for D, F in ((768, 3072), (1024, 4096), (128, 512)):
        worst, worst_gap = 0.0, 0.0
        for M in (10960, 8 * 481, 8 * 257, 17, 1):
            t = _int8_inputs(1, M, D, F, g)
            if M > 4:  # rows of zeros: the scale's floor in quant(ctx)
                t["ctx"][0, 3], t["x"][0, 3] = 0.0, 0.0
                t["ctx"][0, M // 2:] = 0.0
            kernel, plain, split = _k12_calls(t)
            got, want, two = kernel(), plain(), split()
            torch.cuda.synchronize()
            err = max_err(got, want)
            lim = TOL_INT8_REL * max(1.0, float(want.float().abs().max()))
            gap = max_err(got, two)
            gap_lim = TOL_K12_SPLIT * max(1.0, float(two.float().abs().max()))
            if not (err <= lim and gap <= gap_lim and not torch.equal(got, two)
                    and bool(torch.isfinite(got).all()) and got.shape == want.shape):
                raise AssertionError(f"K12 at M {M} D {D} F {F}: max_abs_err {err:.3e} (tol "
                                     f"{lim:.2e}), against K3 -> K4 {gap:.3e} (tol {gap_lim:.2e})")
            worst, worst_gap = max(worst, err / lim), max(worst_gap, gap / gap_lim)
        log(f"  K12 D{D} F{F} at M 10960, 8x481, 8x257, 17, 1 (rows of zeros in ctx): within "
            f"{worst:.2f} of its tolerance to the plain version, {worst_gap:.2f} of its "
            f"tolerance to K3 -> K4 and never equal to it: ok")
    t = _int8_inputs(8, 1370, 768, 3072, g)
    names = device_kernels(_k12_calls(t)[0])
    log(f"  K12: {len(names)} device kernel(s) a call: "
        + ", ".join("attnout_mlp_kernel" if "attnout_mlp_kernel" in n else n[:60] for n in names))
    if len(names) != 1 or "attnout_mlp_kernel" not in names[0]:
        raise AssertionError("K12 must launch one kernel a call")


def phase_k11_kernel():
    """K11's kernel (the OUT_RES instantiation of the attention program,
    csrc/flash_wgmma.cu: a thread-block cluster of one CTA a head over a
    64-row tile): its cluster rule equal to the wrapper's
    (flash_attention.out_res_cluster_size); against its plain version at N 1
    to 1370 around its 64-row tiles (H 12) and at every head count the rule
    takes (1 to 16), with the tolerances of phase_fused_kernels; the int8
    context and row scales that return_quantised gives; a batch element
    whose context is zero (c8 0, the scale's floor, out = res + ls b); one
    device kernel a call; bit-identical run to run."""
    import torch

    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    g = torch.Generator(device="cuda").manual_seed(14)
    lib = _build.library()
    rule = [lib.caim_out_res_cluster_size(h) for h in range(0, 33)]
    if rule != [FA.out_res_cluster_size(h) for h in range(0, 33)]:
        raise AssertionError(f"K11 cluster rule: C {rule} differs from the wrapper's")
    log(f"  K11 cluster rule: C and Python agree at H 0..32; it takes H "
        f"{min(h for h in rule if h)}..{max(rule)}, a cluster of H CTAs")

    def check(B, N, H, v_zero=False):
        """(error / tolerance, share of context values one step off) of one call"""
        args = list(_k11_inputs(B, N, H, g))
        if v_zero:  # batch element 0: every context value 0
            args[2][0] = 0.0
        n = FA.flash_attention_packed_out_res.launches
        got, c8, sc = FA.flash_attention_packed_out_res(*args, 0.125, H, return_quantised=True)
        if FA.flash_attention_packed_out_res.launches != n + 1:
            raise AssertionError("K11 counts one launch a call")
        want = FA.flash_attention_packed_out_res_plain(*args, 0.125, H)
        p8, ps = IB.quantize_activations(FA.attention_context_f32(*args[:3], 0.125, H))
        torch.cuda.synchronize()
        diff = (c8.int() - p8.int()).abs()
        share, most = float((diff > 0).float().mean()), int(diff.max())
        srel = float(((sc - ps).abs() / ps).max())
        err, lim = max_err(got, want), TOL_INT8_REL * max(1.0, float(want.float().abs().max()))
        ok = (err <= lim and share <= TOL_K11_CTX_SHARE and most <= 1 and srel <= TOL_K11_SCALE
              and got.shape == want.shape and bool(torch.isfinite(got).all()))
        if v_zero:  # c8 0 and the floor 1e-12, out = res + ls b in f32, one rounding
            res, ls, b = args[7][0].float(), args[6], args[5]
            ok = ok and not bool(c8[0].any()) and bool((sc[0] == 1e-12).all()) and torch.equal(
                got[0], (res + ls * b).bfloat16()) and torch.equal(got[0], want[0])
        if not ok:
            raise AssertionError(f"K11 at B {B} N {N} H {H}{' (zero context)' if v_zero else ''}:"
                                 f" max_abs_err {err:.3e} (tol {lim:.2e}), int8 context off in "
                                 f"{share:.2e} by at most {most}, scales rel {srel:.2e}")
        return err / lim, share

    worst, worst_share = 0.0, 0.0
    for N in (1, 63, 64, 65, 481, 1369, 1370):
        e, sh = check(2, N, 12)
        worst, worst_share = max(worst, e), max(worst_share, sh)
    log(f"  K11 N 1, 63, 64, 65, 481, 1369, 1370 at H 12: within {worst:.2f} of its tolerance, "
        f"int8 context one step off in at most {worst_share:.2e} (tol {TOL_K11_CTX_SHARE:.0e}): ok")
    worst, worst_share = 0.0, 0.0
    for H in range(1, 17):
        e, sh = check(2, 65 + 64 * (H % 3), H)
        worst, worst_share = max(worst, e), max(worst_share, sh)
    log(f"  K11 H 1..16 (N 65, 129, 193): within {worst:.2f} of its tolerance, int8 context one "
        f"step off in at most {worst_share:.2e}: ok")
    for B, N, H in ((2, 257, 12), (1, 70, 3)):
        check(B, N, H, v_zero=True)
    log("  K11 on a batch element whose context is zero (H 12, 3): c8 0, scales 1e-12, out = "
        "res + ls b bit for bit: ok")
    args = _k11_inputs(8, 1370, 12, g)
    names = device_kernels(lambda: FA.flash_attention_packed_out_res(*args, 0.125, 12))
    again = [FA.flash_attention_packed_out_res(*args, 0.125, 12) for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(*again)
    log(f"  K11: {len(names)} device kernel(s) a call: "
        + ", ".join("flash_wgmma_kernel<out_res>" if "flash_wgmma_kernel" in n else n[:60]
                    for n in names) + f"; bit-identical run to run: {same}")
    if len(names) != 1 or "flash_wgmma_kernel" not in names[0] or not same:
        raise AssertionError("K11 must launch one kernel a call and repeat its bits")


# ------------------------------ the one-pass fc1 GEMM and K6's program (c) ----
def _exact_ln_rows(B, N, D, g):
    """bf16 rows of +-1, +-2 in equal numbers (shuffled): the layernorm's sums
    are exact in any order, so K4a's prologue gives the plain version's bits."""
    import torch

    base = torch.tensor([1.0, -1.0, 2.0, -2.0], device="cuda").repeat(D // 4)
    idx = torch.rand((B * N, D), generator=g, device="cuda").argsort(dim=1)
    return base[idx].view(B, N, D).to(torch.bfloat16)


def _device_events(fn):
    """(name, microseconds) of each device operation of one call of fn
    (torch.profiler), after a call outside the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_kernels(fn):
    """Names of the device kernels one call of fn launches."""
    return [name for name, _ in _device_events(fn)]


def device_busy_ms(fn) -> float:
    """Device time of one call of fn: its kernels' durations summed."""
    busy = sum(us for _, us in _device_events(fn))
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy / 1e3


def phase_fc1_and_focal():
    """K4a and K14's one-pass fc1 GEMM (a thread-block cluster a row tile)
    held to the plain versions' bits at the model's widths, ragged M and
    rows of zeros, with a cluster probe; K6's bf16 program at N 1..1369 around
    its 64-row and 64-key tiles at every width it takes, its colmean run to run,
    and NaN past N."""
    import torch

    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    g = torch.Generator(device="cuda").manual_seed(11)
    lib = _build.library()

    def report(name, tag, ok, detail=""):
        log(f"  {name} {tag}{': ' + detail if detail else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")

    for F in (256, 512, 3072, 4096):
        log(f"  fc1 GEMM at F {F}: a cluster of {lib.caim_fc1_cluster_size(F)} CTAs a "
            f"64-row tile, {lib.caim_fc1_active_clusters(F)} clusters resident at once")
    # bit-equality: K14 on random rows, K4a on rows whose layernorm is exact
    for B, N, D, F in ((8, 1370, 768, 3072), (8, 481, 768, 3072), (1, 17, 128, 256),
                       (2, 40, 256, 512), (2, 257, 1024, 4096)):
        t = _int8_inputs(B, N, D, F, g)
        x = _exact_ln_rows(B, N, D, g)
        for name, (got, want) in (
                ("K14", (IB.int8_fc1_gelu(t["x"], *t["fc1"]),
                         IB.int8_fc1_gelu_plain(t["x"], *t["fc1"]))),
                ("K4a", (IB.int8_fc1_gelu_ln(x, t["gamma"], t["beta"], *t["fc1"]),
                         IB.int8_fc1_gelu_ln_plain(x, t["gamma"], t["beta"], *t["fc1"])))):
            torch.cuda.synchronize()
            report(name, f"B{B} N{N} D{D} F{F} (M {B * N}), bit-equal to the plain version",
                   torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    # rows whose hidden is zero take the 1e-12 floor of the scale
    t = _int8_inputs(2, 70, 768, 3072, g)
    x = t["x"].clone()
    x[0, 3] = 0.0
    x[1, 64:] = 0.0
    wq, ws, b = t["fc1"]
    h8, sh = IB.int8_fc1_gelu(x, wq, ws, torch.zeros_like(b))
    want = IB.int8_fc1_gelu_plain(x, wq, ws, torch.zeros_like(b))
    torch.cuda.synchronize()
    floor = bool((sh[0, 3] == 1e-12).all() and (sh[1, 64:] == 1e-12).all()
                 and not h8[0, 3].any() and not h8[1, 64:].any())
    report("K14", "rows of zeros", floor and torch.equal(h8, want[0]) and torch.equal(sh, want[1]),
           "scale 1e-12, int8 zeros")
    # cluster probe: a large bias in one CTA's columns, each CTA in turn
    for D, F in ((128, 256), (768, 3072), (1024, 4096)):
        t = _int8_inputs(2, 200, D, F, g)
        wq, ws, b = t["fc1"]
        ctas, cols = IB.fc1_cluster_shape(F)
        ok = ctas == lib.caim_fc1_cluster_size(F)
        for q in range(ctas):
            planted = b.clone()
            planted[q * cols + cols // 2] = 30.0
            h8, sh = IB.int8_fc1_gelu(t["x"], wq, ws, planted)
            h8p, shp = IB.int8_fc1_gelu_plain(t["x"], wq, ws, planted)
            torch.cuda.synchronize()
            ok &= (torch.equal(h8, h8p) and torch.equal(sh, shp)
                   and bool((h8[..., q * cols + cols // 2].abs() == 127).all()))
        report("K14", f"cluster probe D{D} F{F}", ok,
               f"each of {ctas} CTAs in turn holds every row's maximum; the others read it "
               f"through distributed shared memory")
    t = _int8_inputs(8, 1370, 768, 3072, g)
    names = device_kernels(lambda: IB.int8_fc1_gelu_ln(t["x"], t["gamma"], t["beta"], *t["fc1"]))
    gemms = [n for n in names if "quant_rows" not in n]
    log(f"  K4a: {len(names)} device kernels a call, {len(gemms)} GEMM after the prologue "
        f"({', '.join(n.split('(')[0] for n in names)})")
    if len(gemms) != 1:
        raise AssertionError("K4a must launch one GEMM a call")

    # K6: every width, lengths around the 64-row and 64-key tiles
    worst, worst_rel = 0.0, 0.0
    for D in (64, 128, 256, 512, 768, 1024):
        for N in (1, 63, 64, 65, 127, 128, 129, 191, 193, 257, 1369):
            q, k, v = (_rand((2, N, D), g, torch.bfloat16, 0.5) for _ in range(3))
            got = FO.focal_attention_fused(q, k, v, (D // 8) ** 0.5)
            ref = FO.focal_attention_plain(q.float(), k.float(), v.float(), (D // 8) ** 0.5)
            torch.cuda.synchronize()
            errs = [max_err(a, b) for a, b in zip(got, ref)]
            tol = focal_tol(ref)
            ok = (errs[0] <= tol and max(errs[1:]) <= TOL_VIEWS
                  and all(bool(torch.isfinite(a).all()) for a in got))
            worst = max(worst, errs[0])
            worst_rel = max(worst_rel, errs[0] / tol * TOL_FOCAL_REL)
            if not ok:
                report("K6", f"B2 N{N} D{D} bf16", False,
                       f"errors {errs} (attended tol {tol:.2e})")
    report("K6", "bf16 at D 64..1024, N 1..1369 around the tiles (66 shapes)", True,
           f"attended max_abs_err {worst:.3e}, at most {worst_rel:.2e} of max |plain| "
           f"(tol {TOL_FOCAL_REL:.0e}), views within {TOL_VIEWS:.0e}")
    q, k, v = (_rand((8, 1369, 768), g, torch.bfloat16, 0.5) for _ in range(3))
    a = FO.focal_attention_fused(q, k, v, 96 ** 0.5)
    b = FO.focal_attention_fused(q, k, v, 96 ** 0.5)
    torch.cuda.synchronize()
    report("K6", "B8 N1369 D768, two runs", all(torch.equal(x, y) for x, y in zip(a, b)),
           "attended and colmean, diag, rowmax bit-identical")
    N, D = 481, 256
    views = []
    for _ in range(3):
        buf = torch.full((1, N + 64, D), float("nan"), device="cuda", dtype=torch.bfloat16)
        buf[:, :N] = _rand((1, N, D), g, torch.bfloat16, 0.5)
        views.append(buf[:, :N])
    got = FO.focal_attention_fused(*views, (D // 8) ** 0.5)
    ref = FO.focal_attention_plain(*(x.float() for x in views), (D // 8) ** 0.5)
    torch.cuda.synchronize()
    ok = (all(bool(torch.isfinite(x).all()) for x in got)
          and max_err(got[0], ref[0]) <= focal_tol(ref)
          and max(max_err(a, b) for a, b in zip(got[1:], ref[1:])) <= TOL_VIEWS)
    report("K6", f"B1 N{N} D{D}, rows past N filled with NaN", ok, "no NaN reaches the outputs")


# ------------------------------------------------------------- slices (d) ----
def _requests(image_size: int, g):
    """(name, uint8 images, exif, guidance) for the three requests."""
    import torch

    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS

    def u8(n, h, w):
        return torch.randint(0, 256, (n, h, w, 3), generator=g, device="cuda",
                             dtype=torch.uint8)

    def exif(n):
        return {"camera_idx": torch.zeros(n, dtype=torch.long, device="cuda"),
                "focal_length": torch.full((n,), 0.25, device="cuda"),
                "aperture": torch.full((n,), 0.127, device="cuda"),
                "iso": torch.full((n,), 0.016, device="cuda")}

    n9 = len(INSTRUCTIONS)
    one = u8(1, 480, 640).expand(n9, -1, -1, -1)
    mixed_g = torch.randint(0, n9, (8,), generator=g, device="cuda")
    return [
        ("nine_instructions", one, exif(n9), torch.arange(n9, device="cuda")),
        ("mixed_batch_8", u8(8, 600, 800), exif(8), mixed_g),
        ("unguided", u8(1, 518, 518), exif(1), None),
    ]


def _serve(model, reqs, image_size):
    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.io.preprocess import resize_normalize

    outs = []
    for _, imgs, exif, gidx in reqs:
        x = resize_normalize(imgs, image_size, image_size)
        outs.append(model(x, exif, guidance=gidx, noise_mode=NoiseMode.ZEROS))
    return outs


def _check_outputs(name, out, B, N):
    import torch

    if out.depth.shape != (B, 1) or out.confidence.shape != (B, 1) \
            or out.attention.shape != (B, N):
        raise AssertionError(f"{name}: unexpected output shapes")
    for field in ("depth", "confidence", "attention", "fused_features"):
        if not bool(torch.isfinite(getattr(out, field)).all()):
            raise AssertionError(f"{name}: non-finite {field}")
    if not bool((out.depth > 0).all()):
        raise AssertionError(f"{name}: depth not positive")
    if not bool(((out.confidence > 0) & (out.confidence < 1)).all()):
        raise AssertionError(f"{name}: confidence outside (0, 1)")
    row_err = float((out.attention.sum(-1) - 1).abs().max())
    if row_err > 1e-4:
        raise AssertionError(f"{name}: attention rows sum to 1 +- {row_err:.2e}")
    return row_err


def _rel(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


def _wrappers():
    """Kernel id -> the wrapper that counts its launches."""
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG

    return {"K1": FA.flash_attention_packed, "K2": IB.int8_qkv_proj_ln,
            "K3": IB.int8_out_residual, "K4": IB.int8_mlp_ln,
            "K4a": IB.int8_fc1_gelu_ln, "K4b": IB.int8_out_residual_prequant,
            "K5": IB.int8_qkv_proj, "K6": FO.focal_attention_fused,
            "K7": FA.flash_attention_packed_bias, "K10": FA.flash_attention_packed_i8qk,
            "K10b": FA.flash_attention_packed_i8qk_bias, "Q": FA.quantize_rows,
            "K8": FA.flash_attention, "K13": IB.int8_proj, "K14": IB.int8_fc1_gelu,
            "K15": IG.int8_gemm_fused, "K9": FA.flash_attention_packed_int8,
            "K11": FA.flash_attention_packed_out_res, "K12": IB.int8_attnout_mlp_ln,
            "Qh": FA.quantize_heads}


def _build_model(policy, image_size, seed, token_filter="", attn_impl="pallas_packed",
                 adapters=None, fold=False):
    """adapters: None, or (rank, alpha, targets): the blocks get adapters whose
    lora_B is drawn N(0, 0.02) from the same generator (zeros, the init's
    value, would hide the path); ``fold`` merges them before the policy's
    transform, as a deployment does."""
    import torch

    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig, parse_token_filter

    lora = {}
    if adapters:
        rank, alpha, targets = adapters
        lora = dict(use_lora=True, lora_rank=rank, lora_alpha=alpha, lora_targets=targets)
    arch = ModelArchConfig(num_iterations=2, image_size=image_size, **lora,
                           **parse_token_filter(token_filter))
    t0 = time.perf_counter()
    model = CognitiveAimModel(arch, policy, attn_impl)  # on the card
    g = torch.Generator(device="cuda").manual_seed(seed)
    model.init(g)
    if adapters:
        for blk in model.backbone.layers:
            for target in adapters[2]:
                blk.adapter(target)[1].data.normal_(0.0, 0.02, generator=g)
        if fold:
            model.merge_lora_params()
    model.prepare_params()
    torch.cuda.synchronize()
    log(f"  model built and initialized in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M float parameters)")
    return model


class _plain_versions:
    """Within the block the model takes the plain versions of its route."""

    def __init__(self, model):
        self.model, self.impl = model, model.attn_impl

    PLAIN = {"pallas_packed": "plain", "pallas_packed_i8qk": "plain_i8qk",
             "pallas": "plain_heads"}

    def __enter__(self):
        self.model.attn_impl = self.PLAIN[self.impl]

    def __exit__(self, *exc):
        self.model.attn_impl = self.impl


def _drive(model, reqs, S, per_forward):
    """Serve the requests through the kernels with the launch counts set to
    0 just before and read just after; check outputs and counts; then serve
    them through the plain versions on the same weights and compare."""
    import torch

    N = (S // 14) ** 2
    wrappers = _wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    outs = _serve(model, reqs, S)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = {k: per_forward.get(k, 0) * len(reqs) for k in wrappers}
    for (name, imgs, _, _), out in zip(reqs, outs):
        row_err = _check_outputs(name, out, imgs.shape[0], N)
        log(f"  {name}: B={imgs.shape[0]} depth {out.depth.min().item():.4f}.."
            f"{out.depth.max().item():.4f} confidence {out.confidence.min().item():.4f}.."
            f"{out.confidence.max().item():.4f} attention rows sum to 1 +- {row_err:.1e}")
    log(f"  launches in {len(reqs)} forwards: "
        + ", ".join(f"{k} {launches[k]} (want {want[k]})" for k in wrappers))
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")

    with _plain_versions(model):
        plain = _serve(model, reqs, S)
    for (name, *_), a, b in zip(reqs, outs, plain):
        rd, rc = _rel(a.depth, b.depth), _rel(a.confidence, b.confidence)
        ok = rd <= TOL_SLICE_BF16 and rc <= TOL_SLICE_BF16
        log(f"  {name} kernels vs plain: depth rel {rd:.2e}, confidence rel {rc:.2e} "
            f"(tol {TOL_SLICE_BF16:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel path disagrees with the plain path")
    return outs, launches


def phase_slices():
    import torch

    from cognitive_aim_tpu_torch.core.precision import (
        DEFAULT_POLICY,
        STRICT_F32,
        policy_from_name,
    )
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig

    S = 518
    reqs = _requests(S, torch.Generator(device="cuda").manual_seed(2))
    log("(d) slice: ViT-B 518x518, 2 focal iterations, default policy, pallas_packed")
    default = _build_model(DEFAULT_POLICY, S, seed=0)
    n_layers, n_iters = default.vit_cfg.num_layers, default.arch.num_iterations
    outs_default, launches_default = _drive(default, reqs, S, {"K1": n_layers, "K6": n_iters})

    log("(d) slice: ViT-B 518x518, 2 focal iterations, int8 policy, pallas_packed "
        "(the same seeded weights, quantised)")
    int8 = _build_model(policy_from_name("int8"), S, seed=0)
    chained = {k: n_layers for k in ("K1", "K2", "K3", "K4", "K4a", "K4b")}
    outs_int8, launches = _drive(int8, reqs, S, {**chained, "K5": n_iters, "K6": n_iters})
    worst = 0.0
    for (name, *_), a, b in zip(reqs, outs_int8, outs_default):
        rd, rc = _rel(a.depth, b.depth), _rel(a.confidence, b.confidence)
        worst = max(worst, rd)
        log(f"  {name} int8 vs default policy: worst depth rel {rd:.2e}, confidence rel "
            f"{rc:.2e} (tol {TOL_POLICY:.0e}; the AbsRel budget on trained weights is "
            f"{POLICY_BUDGET:.0e})")
    if worst > TOL_POLICY:
        raise AssertionError("the int8 policy disagrees with the default policy")

    # strict f32 at 224x224: exercises the f32 kernels inside the model
    arch224 = ModelArchConfig(num_iterations=2, image_size=224)
    f32m = CognitiveAimModel(arch224, STRICT_F32, "pallas_packed")
    f32m.init(torch.Generator(device="cuda").manual_seed(3)).prepare_params()
    x = _rand((2, 224, 224, 3), torch.Generator(device="cuda").manual_seed(4),
              torch.float32)
    wrappers = _wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    a = f32m(x, guidance=torch.tensor([0, 5], device="cuda"))
    torch.cuda.synchronize()
    launches_strict = {kid: w.launches for kid, w in wrappers.items()}
    want = {kid: {"K1": n_layers, "K6": n_iters}.get(kid, 0) for kid in wrappers}
    log("  strict f32 224x224 launches in one forward (the f32 programs): " + ", ".join(
        f"{kid} {launches_strict[kid]} (want {want[kid]})" for kid in ("K1", "K6", "K7", "K8")))
    if launches_strict != want:
        raise AssertionError(f"strict-f32 launch counts {launches_strict} != {want}")
    f32m.attn_impl = "plain"
    b = f32m(x, guidance=torch.tensor([0, 5], device="cuda"))
    rd = max(_rel(a.depth, b.depth), _rel(a.confidence, b.confidence))
    ra = max_err(a.attention, b.attention)
    log(f"  strict f32 224x224 kernels vs plain: depth/confidence rel {rd:.2e}, "
        f"attention abs {ra:.2e} (tol {TOL_SLICE_F32:.0e})")
    if rd > TOL_SLICE_F32 or ra > TOL_SLICE_F32:
        raise AssertionError("strict-f32 kernel path disagrees with the plain path")
    del f32m
    return default, int8, launches, launches_default, launches_strict, reqs


# ---------------------------------------------------- filtered slices (d) ----
FILTERED_SLICES = [
    # name, policy, token filter, attn_impl, stream lengths, launches per forward
    ("1", "int8", "2:0.35", "pallas_packed", (1370, 481),
     {"K1": 12, "K2": 12, "K3": 12, "K4": 12, "K4a": 12, "K4b": 12, "K5": 2, "K6": 2}),
    ("2", "int8", "2:0.35@p", "pallas_packed", (1370, 481),
     {"K1": 2, "K7": 10, "K2": 12, "K3": 12, "K4": 12, "K4a": 12, "K4b": 12, "K5": 2,
      "K6": 2}),
    ("3", "int8", "2:0.35@p", "pallas_packed_i8qk", (1370, 481),
     {"K10": 2, "K10b": 10, "Q": 12, "K2": 12, "K3": 12, "K4": 12, "K4a": 12, "K4b": 12,
      "K5": 2, "K6": 2}),
    ("4", "default", "1:0.6,2:0.3@f4", "pallas_packed", (1370, 826, 416),
     {"K1": 12, "K6": 2}),
]


def _kept_sets(model, x, gidx):
    """One backbone call as the model makes it: (hidden [B, 1 + N, D], kept
    indices [B, k], the token-stream length each block's attention saw)."""
    from cognitive_aim_tpu_torch.nn import dinov2

    lengths, orig = [], dinov2.attend

    def spy(attn_impl, q, *rest):
        lengths.append(q.shape[1])
        return orig(attn_impl, q, *rest)

    dinov2.attend = spy
    try:
        hidden, idx = model.backbone.forward_with_kept(x, **model.backbone_kwargs(x, gidx))
    finally:
        dinov2.attend = orig
    return hidden, idx, lengths


def _check_filtered_backbone(tag, model, x, gidx, stream):
    """The filtered backbone through kernels and through plain versions:
    shape, finite values, stream lengths, frozen dropped tokens (single
    stage), and the overlap of the two kept sets."""
    import torch
    import torch.nn.functional as F

    from cognitive_aim_tpu_torch.nn import layers as L

    bb, cfg = model.backbone, model.vit_cfg
    B, n_tok = x.shape[0], 1 + (x.shape[1] // cfg.patch_size) ** 2
    hidden, idx, lengths = _kept_sets(model, x, gidx)
    with _plain_versions(model):
        _, idx_plain, _ = _kept_sets(model, x, gidx)
    torch.cuda.synchronize()
    if hidden.shape != (B, n_tok, cfg.hidden_size) or not bool(torch.isfinite(hidden).all()):
        raise AssertionError(f"{tag}: backbone output {tuple(hidden.shape)} or not finite")
    bounds = [l for l, _ in model.arch.token_filter_schedule] or [model.arch.token_filter_layer]
    want = [stream[sum(i >= b for b in bounds)] for i in range(cfg.num_layers)]
    if lengths != want:
        raise AssertionError(f"{tag}: stream lengths per block {lengths} != {want}")
    arch = model.arch
    if arch.token_filter_merge:
        # every patch position carries the row of the kept token that stands for
        # it: find each position's nearest kept row and hold it equal bit for bit
        for b in range(B):
            rows = hidden[b, 1:].float()
            kept = rows[idx[b]]
            nearest = torch.cdist(rows, kept).argmin(dim=1)
            if not torch.equal(rows, kept[nearest]):
                raise AssertionError(f"{tag}: a merged position differs from every kept row")
            if len(torch.unique(kept, dim=0)) != kept.shape[0]:
                raise AssertionError(f"{tag}: two kept tokens carry the same row")
    elif len(stream) == 2 and not arch.token_filter_delta_correct:
        # single stage, drop mode: a dropped token is its filter-point value
        kw = model.backbone_kwargs(x, gidx)
        frozen = bb._run(bb.embed(x, kw["compute_dtype"]), 0, bounds[0], kw["attn_impl"])
        frozen = L.layernorm_apply(bb.final_norm, frozen)
        dropped = torch.ones(B, n_tok - 1, dtype=torch.bool, device=x.device)
        dropped.scatter_(1, idx, False)
        if not torch.equal(hidden[:, 1:][dropped], frozen[:, 1:][dropped]):
            raise AssertionError(f"{tag}: a dropped token moved after the filter point")
    k = idx.shape[1]
    both = torch.zeros(B, n_tok - 1, device=x.device).scatter_(1, idx, 1.0)
    overlap = float(both.gather(1, idx_plain).sum(1).min()) / k
    ok = overlap >= MIN_KEPT_OVERLAP
    log(f"  {tag}: backbone {tuple(hidden.shape)}, stream {' -> '.join(map(str, stream))}, "
        f"kept {k} of {n_tok - 1}; kept sets of kernels and plain versions overlap "
        f"{overlap:.4f} in the worst sample (min {MIN_KEPT_OVERLAP}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kept sets of the kernel and plain paths differ")


def phase_filtered_slices(reqs):
    """The token-filter fast path at full width: each slice through the
    kernels (launch counts asserted) and through the plain versions."""
    import torch

    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.io.preprocess import resize_normalize

    S = 518
    mixed, unguided = reqs[1], reqs[2]
    models, launches = {}, {}
    for name, policy, spec, impl, stream, per_forward in FILTERED_SLICES:
        log(f"(d) filtered slice {name}: ViT-B 518x518, {policy} policy, token filter "
            f"{spec}, {impl}")
        model = _build_model(policy_from_name(policy), S, seed=0, token_filter=spec,
                             attn_impl=impl)
        served = [mixed, unguided] if name == "2" else [mixed]
        _, launches[name] = _drive(model, served, S, per_forward)
        for req_name, imgs, _, gidx in served:
            _check_filtered_backbone(f"slice {name} {req_name}", model,
                                     resize_normalize(imgs, S, S), gidx, stream)
        models[name] = model
    return models, launches


# ----------------------------------------------------- adapter slices (d) ----
ATTN_OUT_16 = (16, 16, ("attn_out",))  # configs/experiment_B.yaml: rank 16, attn_out
SANDWICH_64 = (64, 64, ("qkv", "attn_out", "fc1", "fc2"))  # merge_lora's docstring
_CHAINED = {"K2": 12, "K3": 12, "K4": 12, "K4a": 12, "K4b": 12, "K5": 2, "K6": 2}
ADAPTER_SLICES = [
    # name, policy, adapters, folded, token filter, attn_impl, stream lengths,
    # launches per forward
    ("A1", "default", ATTN_OUT_16, False, "", "pallas_packed", None, {"K1": 12, "K6": 2}),
    ("A2", "default", ATTN_OUT_16, False, "", "pallas", None, {"K8": 12, "K6": 2}),
    ("A3", "int8", SANDWICH_64, False, "", "pallas_packed", None,
     {"K15": 12, "K1": 12, "K5": 2, "K6": 2}),
    ("A4", "int8", SANDWICH_64, True, "2:0.35", "pallas_packed", (1370, 481),
     {"K1": 12, **_CHAINED}),
    ("A5", "int8", SANDWICH_64, True, "2:0.35@m@p", "pallas_packed", (1370, 480),
     {"K1": 2, "K7": 10, **_CHAINED}),
    ("A6", "int8", SANDWICH_64, True, "2:0.35@d", "pallas_packed", (1370, 481),
     {"K1": 12, **_CHAINED}),
]


class _adapters_gated_off:
    """Within the block the backbone runs as one built without ``use_lora``
    does on the same tensors: it holds the adapters and ignores them."""

    def __init__(self, model):
        self.blocks = list(model.backbone.layers)

    def _set(self, on: bool):
        import dataclasses

        for blk in self.blocks:
            blk.cfg = dataclasses.replace(blk.cfg, use_lora=on)

    def __enter__(self):
        self._set(False)

    def __exit__(self, *exc):
        self._set(True)


def phase_adapter_slices(reqs):
    """The adapter path at full width: runtime adapters under both policies
    (under int8 the unchained block through K15), attn_impl="pallas" through
    K8, and the folded deployment with the filter's drop mode, merge mode and
    delta correction. Each through the kernels (launch counts asserted) and
    through the plain versions."""
    import torch

    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.io.preprocess import resize_normalize

    S = 518
    mixed = reqs[1]
    models, launches = {}, {}
    for name, policy, adapters, fold, spec, impl, stream, per_forward in ADAPTER_SLICES:
        rank, _, targets = adapters
        log(f"(d) adapter slice {name}: ViT-B 518x518, {policy} policy, rank {rank} on "
            f"{', '.join(targets)}{', folded' if fold else ''}, "
            f"{'token filter ' + spec if spec else 'no filter'}, {impl}")
        model = _build_model(policy_from_name(policy), S, seed=0, token_filter=spec,
                             attn_impl=impl, adapters=adapters, fold=fold)
        blocks = model.backbone.layers
        if fold:
            if any(b.has_adapters for b in blocks) or not all(b.chained(impl) == (
                    policy == "int8") for b in blocks):
                raise AssertionError(f"{name}: the fold left adapters or the unchained block")
        else:
            b_max = min(float(b.adapter(t)[1].detach().abs().max())
                        for b in blocks for t in targets)
            if not b_max > 0 or any(b.chained(impl) for b in blocks):
                raise AssertionError(f"{name}: adapters are not live")
        _, launches[name] = _drive(model, [mixed], S, per_forward)
        if stream is not None:
            _check_filtered_backbone(f"slice {name} {mixed[0]}", model,
                                     resize_normalize(mixed[1], S, S), mixed[3], stream)
        models[name] = model

    # what the adapters do, and the fold against the runtime adapters, under the
    # default policy on one set of weights (the same seed, so the same draws)
    policy = policy_from_name("default")
    on = _build_model(policy, S, seed=0, adapters=SANDWICH_64)
    folded = _build_model(policy, S, seed=0, adapters=SANDWICH_64, fold=True)
    x = resize_normalize(mixed[1], S, S)

    def serve(m):
        return m(x, mixed[2], guidance=mixed[3], noise_mode=NoiseMode.ZEROS)

    outs = {"on": serve(on), "folded": serve(folded)}
    with _adapters_gated_off(on):
        outs["off"] = serve(on)
    rd = _rel(outs["folded"].depth, outs["on"].depth)
    rc = _rel(outs["folded"].confidence, outs["on"].confidence)
    effect = _rel(outs["on"].depth, outs["off"].depth)
    ok = rd <= TOL_SLICE_BF16 and rc <= TOL_SLICE_BF16 and effect >= MIN_ADAPTER_EFFECT
    log(f"  default policy, rank 64 on all four targets: folded vs runtime adapters depth rel "
        f"{rd:.2e}, confidence rel {rc:.2e} (tol {TOL_SLICE_BF16:.0e}); adapters on vs off "
        f"depth rel {effect:.2e} (min {MIN_ADAPTER_EFFECT:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the folded model disagrees with its runtime adapters, or the "
                             "adapters do nothing")
    del on, folded
    return models, launches


# ------------------------------------------------------ fused slices (d) ----
class _fuse_aomlp:
    """Within the block the environment has ``CAIM_FUSE_AOMLP=1``, the JAX
    package's switch that the chained int8 block reads at every call."""

    def __enter__(self):
        self.before = os.environ.get("CAIM_FUSE_AOMLP")
        os.environ["CAIM_FUSE_AOMLP"] = "1"

    def __exit__(self, *exc):
        if self.before is None:
            del os.environ["CAIM_FUSE_AOMLP"]
        else:
            os.environ["CAIM_FUSE_AOMLP"] = self.before


FUSED = {"K1": 12, "K2": 12, "K12": 12, "K5": 2, "K6": 2}  # K3 = K4 = K4a = K4b = 0


def _block_chain(model, x, route, plain=False):
    """The backbone's blocks as chained int8 steps assembled by hand from each
    block's own weights: K2 -> attention -> the rest, where ``route`` is
    "split" (K1, K3, K4: what the model runs), "K11" (K11 in place of K1 and
    K3) or "K9" (K9 in place of K1). ``plain``: every step's plain version."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB

    def pick(fn, fn_plain):
        return fn_plain if plain else fn

    cfg = model.vit_cfg
    scale, H, eps = cfg.head_dim ** -0.5, cfg.num_heads, cfg.layer_norm_eps
    with torch.no_grad():  # the weights are parameters; nothing here differentiates
        for blk in model.backbone.layers:
            n1, n2, ao = blk.norm1, blk.norm2, blk.attn_out
            q, k, v = pick(IB.int8_qkv_proj_ln, IB.int8_qkv_proj_ln_plain)(
                x, n1.weight, n1.bias, blk.qkv.wq, blk.qkv.ws, blk.qkv.bias, eps)
            if route == "K11":
                x = pick(FA.flash_attention_packed_out_res,
                         FA.flash_attention_packed_out_res_plain)(
                    q, k, v, ao.wq, ao.ws, ao.bias, blk.ls1, x, scale, H)
            else:
                if route == "K9":
                    ctx = pick(FA.flash_attention_packed_int8,
                               FA.flash_attention_packed_int8_plain)(q, k, v, scale, H)
                else:
                    ctx = pick(FA.flash_attention_packed,
                               FA.flash_attention_packed_plain)(q, k, v, scale, H)
                x = pick(IB.int8_out_residual, IB.int8_out_residual_plain)(
                    ctx, ao.wq, ao.ws, ao.bias, blk.ls1, x)
            x = pick(IB.int8_mlp_ln, IB.int8_mlp_ln_plain)(
                x, n2.weight, n2.bias, blk.fc1.wq, blk.fc1.ws, blk.fc1.bias, blk.fc2.wq,
                blk.fc2.ws, blk.fc2.bias, blk.ls2, eps)
    return x


BLOCK_CHAINS = {
    # route: launches in one pass over the 12 blocks
    "K11": {"K2": 12, "K11": 12, "K4": 12, "K4a": 12, "K4b": 12},
    "K9": {"K2": 12, "K9": 12, "Qh": 12, "K3": 12, "K4": 12, "K4a": 12, "K4b": 12},
}


def phase_fused_slices(int8, filtered_1, reqs):
    """F1 and F2: the int8 exact and ``2:0.35`` slices with K12 in place of K3
    and K4 (``CAIM_FUSE_AOMLP=1``), launch counts asserted, each against its
    plain twin under the same variable and against the unfused slice. Then
    K11 and K9 in place: the 12 blocks of the int8 model as chained steps
    assembled by hand, against the same steps' plain versions and against the
    steps the model runs."""
    import torch

    from cognitive_aim_tpu_torch.io.preprocess import resize_normalize

    S = 518
    launches = {}
    for name, model, served, stream in (("F1", int8, reqs, None),
                                        ("F2", filtered_1, [reqs[1]], (1370, 481))):
        log(f"(d) fused slice {name}: ViT-B 518x518, int8 policy, "
            f"{'token filter 2:0.35' if stream else 'no filter'}, pallas_packed, "
            f"CAIM_FUSE_AOMLP=1 (the weights of the unfused slice)")
        unfused = _serve(model, served, S)
        with _fuse_aomlp():
            outs, launches[name] = _drive(model, served, S, FUSED)
            if stream:
                _check_filtered_backbone(f"slice {name} {served[0][0]}", model,
                                         resize_normalize(served[0][1], S, S), served[0][3],
                                         stream)
        for (req, *_), a, b in zip(served, outs, unfused):
            rd, rc = _rel(a.depth, b.depth), _rel(a.confidence, b.confidence)
            same = torch.equal(a.depth, b.depth) and torch.equal(a.fused_features,
                                                                 b.fused_features)
            ok = rd <= TOL_SLICE_BF16 and rc <= TOL_SLICE_BF16 and not same
            log(f"  {req} fused vs unfused: depth rel {rd:.2e}, confidence rel {rc:.2e} "
                f"(tol {TOL_SLICE_BF16:.0e}; not bit-equal: {not same}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: the fused slice disagrees with the unfused one, "
                                     f"or is the unfused one")
    if os.environ.get("CAIM_FUSE_AOMLP", "0") == "1":
        raise AssertionError("CAIM_FUSE_AOMLP was not restored")

    # K11 and K9 in place
    x0 = int8.backbone.embed(resize_normalize(reqs[1][1], S, S),
                             int8.policy.backbone_compute_dtype)
    wrappers = _wrappers()
    split = _block_chain(int8, x0, "split")
    split_plain = _block_chain(int8, x0, "split", plain=True)
    for route, want in BLOCK_CHAINS.items():
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        got = _block_chain(int8, x0, route)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        if counts != {k: want.get(k, 0) for k in wrappers}:
            raise AssertionError(f"block chain {route}: launch counts {counts}")
        launches[route] = counts
        ref = _block_chain(int8, x0, route, plain=True)
        torch.cuda.synchronize()
        def apart(a, b):
            """(largest difference over the largest value, RMS difference over
            the RMS value) of two hidden states."""
            d, b = (a.float() - b.float()), b.float()
            return (float(d.abs().max() / b.abs().max()),
                    float(d.square().mean().sqrt() / b.square().mean().sqrt()))

        (err, err_rms), (gap, gap_rms) = apart(got, ref), apart(got, split)
        base, base_rms = apart(split, split_plain)
        ok = (max(err, gap) <= TOL_CHAIN_MAX and max(err_rms, gap_rms) <= TOL_CHAIN_RMS
              and bool(torch.isfinite(got).all()))
        log(f"  {route} in place, 12 blocks on {tuple(x0.shape)} (launches "
            + ", ".join(f"{k} {n}" for k, n in counts.items() if n)
            + f"): against the plain steps max {err:.2e} of the largest value, RMS {err_rms:.2e}"
            f" of the RMS value; against the model's steps (K1, K3, K4) max {gap:.2e}, RMS "
            f"{gap_rms:.2e} (tol max {TOL_CHAIN_MAX:.0e}, RMS {TOL_CHAIN_RMS:.0e}; the model's "
            f"steps against their own plain versions: max {base:.2e}, RMS {base_rms:.2e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"block chain {route} disagrees")
    return launches, x0


# -------------------------------------------------------------- times (e) ----
def _host_enqueue_ms(fn, iters: int = 5) -> float:
    """Host clock from the call to its return (no synchronise inside), the
    device drained before each call."""
    import torch

    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def _time_kernel(name, shape, kernel, plain, bound_, library=None, check=None,
                 device=False):
    """{shape, ms, plain_ms, bound_ms, bound_by, library_ms}: the wrapper and
    its plain version by CUDA events, the bound, and the library call where
    one PyTorch call computes the same function. With ``check`` (a call that
    runs the wrapper and its plain version and returns (max abs error, within
    tolerance, detail)) first the outputs, held to their tolerance, and
    ``max_abs_err``; with ``device`` also ``device_ms``, the wrapper's device
    time by CUDA graphs, which the host's launch rate does not mask."""
    import torch

    t = {"shape": shape}
    if check is not None:
        err, ok, detail = check()
        torch.cuda.synchronize()
        log(f"  {name} {shape} against its plain version: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")
        t["max_abs_err"] = err
    t.update({"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
              "bound_ms": bound_[0], "bound_by": bound_[1],
              "library_ms": cuda_ms(library) if library else None})
    if device:
        t["device_ms"] = graph_ms(kernel)
    lib = f", library call {t['library_ms']:.3f} ms" if library else ""
    dev = f", device time by CUDA graphs {t['device_ms']:.4f} ms" if device else ""
    log(f"  {name} {shape}: kernel {t['ms']:.3f} ms{dev}, plain {t['plain_ms']:.3f} ms{lib}, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return t


def _attention_case(B, N, D, H, dtype, g):
    """K1 on seeded [B, N, D] q, k, v of ``dtype`` over H heads of 64:
    (shape, kernel, plain, bound, library call, check) for _time_kernel; the
    check against the plain version on the inputs in f32, as phase (c)."""
    import torch
    import torch.nn.functional as F

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    q, k, v = (_rand((B, N, D), g, dtype) for _ in range(3))
    heads = [t.view(B, N, H, D // H).transpose(1, 2) for t in (q, k, v)]
    kind = "bf16" if dtype == torch.bfloat16 else "f32"

    def kernel():
        return FA.flash_attention_packed(q, k, v, 0.125, H)

    def check():
        ref = FA.flash_attention_packed_plain(q.float(), k.float(), v.float(), 0.125, H)
        return _flash_check(kernel(), ref, dtype)

    # 4 B H N^2 Dh operations; q, k, v read and out written once
    return (f"B{B} N{N} H{H} {kind}", kernel,
            lambda: FA.flash_attention_packed_plain(q, k, v, 0.125, H),
            bound(4 * B * N * D * dtype.itemsize, 4 * B * N * N * D, kind),
            lambda: F.scaled_dot_product_attention(*heads, scale=0.125), check)


def _kernel_table(B, N, D, Fh, H, g):
    """The kernels of the int8 and strict forwards at one model's shapes (B
    images of N tokens, D wide, H heads, MLP Fh; K5 and K6 on the N - 1
    patches): name -> (shape, kernel, plain, bound, library call, check) for
    _time_kernel, each held to phase (c)'s tolerance; and the int8 inputs."""
    import torch

    from cognitive_aim_tpu_torch.kernels import focal_attention as FO

    table = {"K1": _attention_case(B, N, D, H, torch.bfloat16, g),
             "K1f32": _attention_case(B, N, D, H, torch.float32, g)}
    Nf, scale = N - 1, (D // 8) ** 0.5
    for name, dtype, kind in (("K6", torch.bfloat16, "bf16"), ("K6f32", torch.float32, "f32")):
        q, k, v = (_rand((B, Nf, D), g, dtype, 0.5) for _ in range(3))

        def kernel(q=q, k=k, v=v):
            return FO.focal_attention_fused(q, k, v, scale)

        def check(q=q, k=k, v=v, dtype=dtype, kernel=kernel):
            ref = FO.focal_attention_plain(q.float(), k.float(), v.float(), scale)
            return _focal_check(kernel(), ref, dtype)

        # 4 B N^2 D operations; q, k, v, attended once (the three views are 3 B N f32)
        table[name] = (f"B{B} N{Nf} D{D} {kind}", kernel,
                       lambda q=q, k=k, v=v: FO.focal_attention_plain(q, k, v, scale),
                       bound(4 * B * Nf * D * dtype.itemsize + 3 * B * Nf * 4,
                             4 * B * Nf * Nf * D, kind), None, check)

    def int8_case(name, shape, calls, bnd):
        kernel, plain = calls
        return (shape, kernel, plain, bnd, None, lambda: _int8_check(name, kernel(), plain()))

    # int8 kernels: 2 M K N int8 operations; bytes: activations in and out
    # once (bf16 2 bytes, int8 1), the int8 weight, the f32 vectors
    t = _int8_inputs(B, N, D, Fh, g)
    calls = _int8_calls(t)
    M, act = B * N, B * N * D * 2
    for name, bnd in (
            ("K2", bound(act + 3 * D * D + 3 * act + 8 * D + 24 * D, 2 * M * D * 3 * D, "int8")),
            ("K3", bound(3 * act + D * D + 12 * D, 2 * M * D * D, "int8")),
            ("K4a", bound(act + Fh * D + M * Fh + 4 * M + 8 * D + 8 * Fh, 2 * M * D * Fh,
                          "int8")),
            ("K4b", bound(M * Fh + 4 * M + Fh * D + 2 * act + 12 * D, 2 * M * D * Fh, "int8")),
            ("K4", bound(2 * act + 2 * Fh * D + 8 * Fh + 20 * D, 4 * M * D * Fh, "int8"))):
        table[name] = int8_case(name, f"B{B} N{N} D{D} F{Fh}", calls[name], bnd)
    # K12: ctx and res in, out out, the three int8 weights, the f32 vectors;
    # the three products
    table["K12"] = int8_case("K12", f"B{B} N{N} D{D} F{Fh}", _k12_calls(t)[:2],
                             bound(3 * act + D * D + 2 * Fh * D + 4 * Fh + 40 * D,
                                   2 * M * D * D + 4 * M * D * Fh, "int8"))
    M5 = B * Nf
    table["K5"] = int8_case("K5", f"B{B} N{Nf} D{D}",
                            _int8_calls(_int8_inputs(B, Nf, D, Fh, g))["K5"],
                            bound(4 * M5 * D * 2 + 3 * D * D + 24 * D, 2 * M5 * D * 3 * D,
                                  "int8"))
    return table, t


def phase_kernel_times(smi):
    """name -> {ms, plain_ms, bound_ms, bound_by, library_ms} at the slice's
    shapes (B 8, N 1370, K5 and K6 N 1369)."""
    import torch
    import torch.nn.functional as F

    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG
    from cognitive_aim_tpu_torch.kernels import int8_ops as I8

    log(f"(e) times with CUDA events on {smi}")
    g = torch.Generator(device="cuda").manual_seed(5)
    B, N, D, Fh, H = 8, 1370, 768, 3072, 12
    times = {}

    def ratio(name, kernel, library):
        """The kernel's time over its library call's, timed again in turns
        (kernel, library, library, kernel) so that both see the same clocks;
        the means replace the kernel's and the library call's times."""
        t = times[name]
        k_ms, l_ms = [cuda_ms(kernel)], [cuda_ms(library)]
        l_ms.append(cuda_ms(library))
        k_ms.append(cuda_ms(kernel))
        t["ms"], t["library_ms"] = sum(k_ms) / 2, sum(l_ms) / 2
        t["library_ratio"] = t["ms"] / t["library_ms"]
        log(f"  {name} / library call in turns: kernel {k_ms[0]:.4f}/{k_ms[1]:.4f} ms, library "
            f"call {l_ms[0]:.4f}/{l_ms[1]:.4f} ms, ratio {t['library_ratio']:.3f}")

    def record(name, shape, kernel, plain, bound_, library=None):
        times[name] = _time_kernel(name, shape, kernel, plain, bound_, library)

    # K1, K1 f32, K6, K6 f32, K2-K5 and K12, each held to its plain version
    # first, as phase (m) at ViT-L's shapes
    table, int8_in = _kernel_table(B, N, D, Fh, H, g)
    for name, case in table.items():
        times[name] = _time_kernel(name, *case, device=True)
    ratio("K1", table["K1"][1], table["K1"][4])
    ratio("K1f32", table["K1f32"][1], table["K1f32"][4])
    q, k, v = (_rand((B, N, D), g, torch.bfloat16) for _ in range(3))

    def heads(t):
        return t.view(B, N, H, D // H).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(heads(q), heads(k), heads(v), scale=0.125)

    # K8: K1's work on [B, N, H, 64] views
    q4, k4, v4 = (t.view(B, N, H, D // H) for t in (q, k, v))
    def k8():
        return FA.flash_attention(q4, k4, v4, 0.125)

    record("K8", f"B{B} N{N} H{H} bf16", k8,
           lambda: FA.attention_reference(q4, k4, v4, 0.125),
           bound(4 * B * N * D * 2, 4 * B * N * N * D, "bf16"), sdpa)
    ratio("K8", k8, sdpa)
    # K7, K10, K10b at the filtered stream's N 481 (the shape of the kernels
    # line for K7 and K10b) and at N 1370 (K10's). Bytes as K1 plus the f32
    # bias row; K10's first product counts at the int8 rate. The wrappers of
    # K10 and K10b include the quantising launch.
    main, other = {}, {}
    for Nk in (481, N):
        qn, kn, vn = (_rand((B, Nk, D), g, torch.bfloat16) for _ in range(3))
        bias = _bias_rows(B, Nk, g)["counts"]
        mask = bias[:, None, None, :].to(torch.bfloat16).expand(B, H, Nk, Nk)
        nbytes, half = 4 * B * Nk * D * 2, 2 * B * Nk * Nk * D

        def hn(t, Nk=Nk):
            return t.view(B, Nk, H, D // H).transpose(1, 2)

        cases = {
            "K7": (lambda: FA.flash_attention_packed_bias(qn, kn, vn, bias, 0.125, H),
                   lambda: FA.flash_attention_packed_bias_plain(qn, kn, vn, bias, 0.125, H),
                   bound(nbytes + 4 * B * Nk, 2 * half, "bf16"),
                   lambda: F.scaled_dot_product_attention(hn(qn), hn(kn), hn(vn),
                                                          attn_mask=mask, scale=0.125)),
            "K10": (lambda: FA.flash_attention_packed_i8qk(qn, kn, vn, 0.125, H),
                    lambda: FA.flash_attention_packed_i8qk_plain(qn, kn, vn, 0.125, H),
                    bound(nbytes, {"int8": half, "bf16": half}), None),
            "K10b": (lambda: FA.flash_attention_packed_i8qk_bias(qn, kn, vn, bias, 0.125, H),
                     lambda: FA.flash_attention_packed_i8qk_bias_plain(qn, kn, vn, bias,
                                                                       0.125, H),
                     bound(nbytes + 4 * B * Nk, {"int8": half, "bf16": half}), None),
        }
        for name, (kernel, plain, bnd, library) in cases.items():
            record(name, f"B{B} N{Nk} H{H} bf16", kernel, plain, bnd, library)
            if library:
                ratio(name, kernel, library)
            # the kernels line takes K10 at N 1370, K7 and K10b at N 481
            (main if (Nk == N) == (name == "K10") else other)[name] = times.pop(name)
            if name == "K7":  # K1 at the same shape, for the cost of the bias row
                def k1n():
                    return FA.flash_attention_packed(qn, kn, vn, 0.125, H)

                def sdpa_n():
                    return F.scaled_dot_product_attention(hn(qn), hn(kn), hn(vn), scale=0.125)

                k1_ms, sdpa_ms = cuda_ms(k1n), cuda_ms(sdpa_n)
                # device time alone, from CUDA graphs (at N 481 cuda_ms reads
                # the host's launch rate), K7 with them
                dev = {"K1": graph_ms(k1n), "sdpa": graph_ms(sdpa_n), "K7": graph_ms(kernel),
                       "masked_sdpa": graph_ms(library)}
                log(f"  K1 B{B} N{Nk} H{H} bf16 in the same run: kernel {k1_ms:.4f} ms, "
                    f"scaled_dot_product_attention {sdpa_ms:.4f} ms, ratio "
                    f"{k1_ms / sdpa_ms:.3f}; device time (CUDA graphs): K1 {dev['K1']:.4f}, "
                    f"SDPA {dev['sdpa']:.4f} (ratio {dev['K1'] / dev['sdpa']:.3f}), K7 "
                    f"{dev['K7']:.4f}, masked SDPA {dev['masked_sdpa']:.4f} ms")
                (main if Nk == 481 else other)["K1_here"] = {
                    "ms": k1_ms, "sdpa_ms": sdpa_ms, "device_ms": dev}
        # K10 and K10b beside K1 and K7 by CUDA graphs, in turns (yardstick,
        # kernel alone, wrapper, wrapper, kernel alone, yardstick): the
        # attention kernel alone on q and k quantised once, and the wrapper
        # with its quantising launch
        q8, sq, k8, sk = FA.quantize_rows(qn, kn)
        for name, yard, alone in (
                ("K10", ("K1", lambda: FA.flash_attention_packed(qn, kn, vn, 0.125, H)),
                 lambda: FA._launch_i8qk_kernel(q8, sq, k8, sk, vn, None, 0.125, H)),
                ("K10b", ("K7", lambda: FA.flash_attention_packed_bias(qn, kn, vn, bias, 0.125,
                                                                      H)),
                 lambda: FA._launch_i8qk_kernel(q8, sq, k8, sk, vn, bias, 0.125, H))):
            wrapper = cases[name][0]
            runs = [(yard[0], yard[1]), ("kernel", alone), ("wrapper", wrapper)]
            dev = {n: [] for n, _ in runs}
            for n, fn in runs + runs[::-1]:
                dev[n].append(graph_ms(fn))
            t = (main if (Nk == N) == (name == "K10") else other)[name]
            t["graphs"] = {n: sum(v) / 2 for n, v in dev.items()}
            t["graphs_in_turns"] = dev
            ratio_ = t["graphs"]["kernel"] / t["graphs"][yard[0]]
            log(f"  {name} B{B} N{Nk} H{H} by CUDA graphs in turns with {yard[0]}: "
                f"{yard[0]} {dev[yard[0]][0]:.4f}/{dev[yard[0]][1]:.4f} ms, {name}'s kernel "
                f"{dev['kernel'][0]:.4f}/{dev['kernel'][1]:.4f} ms (x{ratio_:.2f} {yard[0]}), "
                f"with its quantising launch {dev['wrapper'][0]:.4f}/{dev['wrapper'][1]:.4f} ms")
        # Q: bf16 rows read, int8 rows and f32 scales written; no product. The
        # wrappers of K10 and K10b quantise q and k in one launch
        record("Q", f"B{B} N{Nk} D{D} bf16, q and k", lambda: FA.quantize_rows(qn, kn),
               lambda: FA.quantize_rows_plain(qn, kn),
               bound(2 * (3 * B * Nk * D + 4 * B * Nk), 0, "bf16"))
        times["Q"]["device_ms"] = graph_ms(lambda: FA.quantize_rows(qn, kn))
        log(f"  Q device time by CUDA graphs: {times['Q']['device_ms']:.4f} ms")
        (main if Nk == 481 else other)["Q"] = times.pop("Q")
    times["K1"]["at_n481"] = main.pop("K1_here")
    times["K1"]["device_ms_n1370"] = other.pop("K1_here")["device_ms"]
    for name in main:
        times[name] = {**main[name], "other_shape": other[name]}

    # the strict policy's f32 programs of K7 and K8: the same operations on the
    # f32 FMA pipes (TF32 off), q, k, v, out read and written once in f32; SDPA
    # in f32 beside
    qf, kf, vf = (_rand((B, N, D), g, torch.float32) for _ in range(3))
    bias = _bias_rows(B, N, g)["every_key"]
    f32_bytes = 4 * B * N * D * 4

    def sdpa_f32(mask=None):
        hf = [t.view(B, N, H, D // H).transpose(1, 2) for t in (qf, kf, vf)]
        return F.scaled_dot_product_attention(*hf, attn_mask=mask, scale=0.125)

    mask = bias[:, None, None, :]
    record("K7f32", f"B{B} N{N} H{H} f32, bias on every key",
           lambda: FA.flash_attention_packed_bias(qf, kf, vf, bias, 0.125, H),
           lambda: FA.flash_attention_packed_bias_plain(qf, kf, vf, bias, 0.125, H),
           bound(f32_bytes + B * N * 4, 4 * B * N * N * D, "f32"), lambda: sdpa_f32(mask))
    qf4, kf4, vf4 = (t.view(B, N, H, D // H) for t in (qf, kf, vf))
    record("K8f32", f"B{B} N{N} H{H} f32", lambda: FA.flash_attention(qf4, kf4, vf4, 0.125),
           lambda: FA.attention_reference(qf4, kf4, vf4, 0.125),
           bound(f32_bytes, 4 * B * N * N * D, "f32"), sdpa_f32)
    del qf, kf, vf, qf4, kf4, vf4

    t = int8_in
    M, Nf = B * N, N - 1
    act = M * D * 2

    def linear_bound(M, K, Nout):
        """bf16 rows in and out once, the int8 weight, the two f32 vectors."""
        return bound(2 * M * K + K * Nout + 2 * M * Nout + 8 * Nout, 2 * M * K * Nout, "int8")

    # K15 at the shape the unchained block gives it: the fused qkv projection
    x, w, b = _proj_inputs((M,), D, 3 * D, g)
    record("K15", f"M{M} K{D} -> {3 * D}", lambda: IG.int8_gemm_fused(x, w["q"], w["s"], b),
           lambda: IG.int8_gemm_fused_plain(x, w["q"], w["s"], b), linear_bound(M, D, 3 * D))
    # The callers of the GEMM program (int8_gemm_tma_kernel) also by CUDA
    # graphs, each beside torch._int_mm at its [M, K] x [K, N]: a yardstick
    # of the product alone (int32 out, no prologue or epilogue), not a port
    def int_mm_ms(Mg, Kg, Ng):
        a8 = torch.randint(-127, 128, (Mg, Kg), generator=g, device="cuda", dtype=torch.int8)
        b8 = torch.randint(-127, 128, (Ng, Kg), generator=g, device="cuda", dtype=torch.int8)
        return graph_ms(lambda: torch._int_mm(a8, b8.t()))

    def gemm_graphs(name, fn, Mg, Kg, Ng):
        t = times[name]
        if "device_ms" not in t:  # the table's kernels have theirs
            t["device_ms"] = graph_ms(fn)
        t["int_mm_yardstick_ms"] = int_mm_ms(Mg, Kg, Ng)
        log(f"  {name} [{Mg}, {Kg}] x [{Kg}, {Ng}] device time by CUDA graphs: "
            f"{t['device_ms']:.4f} ms (events {t['ms']:.4f}); torch._int_mm yardstick "
            f"{t['int_mm_yardstick_ms']:.4f} ms")

    gemm_graphs("K2", table["K2"][1], M, D, 3 * D)
    gemm_graphs("K3", table["K3"][1], M, D, D)
    gemm_graphs("K4b", table["K4b"][1], M, Fh, D)
    gemm_graphs("K5", table["K5"][1], B * Nf, D, 3 * D)
    gemm_graphs("K15", lambda: IG.int8_gemm_fused(x, w["q"], w["s"], b), M, D, 3 * D)
    # K13 at the three shapes at which the unchained block calls
    # int8_ops.int8_linear (attn_out, fc1, fc2), beside that function
    shapes = {}
    for K, Nout in ((D, Fh), (D, D), (Fh, D)):
        x, w, b = _proj_inputs((B, N), K, Nout, g)
        record("K13", f"B{B} N{N} K{K} -> {Nout}", lambda: IB.int8_proj(x, w["q"], w["s"], b),
               lambda: IB.int8_proj_plain(x, w["q"], w["s"], b), linear_bound(M, K, Nout))
        ms = cuda_ms(lambda: I8.int8_linear(x, w, b))
        log(f"  int8_ops.int8_linear at that shape (row quantisation, torch._int_mm, "
            f"dequantisation): {ms:.3f} ms")
        gemm_graphs("K13", lambda: IB.int8_proj(x, w["q"], w["s"], b), M, K, Nout)
        shapes[(K, Nout)] = {**times.pop("K13"), "int8_linear_ms": ms}
    times["K13"] = {**shapes.pop((D, Fh)), "other_shape": list(shapes.values())}
    # K14: K4a's work without the layernorm
    record("K14", f"B{B} N{N} D{D} F{Fh}", lambda: IB.int8_fc1_gelu(t["x"], *t["fc1"]),
           lambda: IB.int8_fc1_gelu_plain(t["x"], *t["fc1"]),
           bound(act + Fh * D + M * Fh + 4 * M + 8 * Fh, 2 * M * D * Fh, "int8"))

    # K14 also by CUDA graphs: its device time without the host's launch rate
    times["K14"]["device_ms"] = graph_ms(lambda: IB.int8_fc1_gelu(t["x"], *t["fc1"]))
    log(f"  K14 device time by CUDA graphs: {times['K14']['device_ms']:.4f} ms "
        f"(events {times['K14']['ms']:.4f})")
    log(f"  fc1 GEMM at F {Fh}: {IB.fc1_cluster_shape(Fh)[0]} CTAs a cluster, "
        f"{_build.library().caim_fc1_active_clusters(Fh)} clusters resident at once; "
        f"GEMM launches per K4a call: "
        f"{sum('quant_rows' not in n for n in device_kernels(table['K4a'][1]))}")
    # The fused variants, each beside the kernels it fuses, timed here in turns
    # (fused, parts, parts, fused). K11: q, k, v, res in, out out, the attn_out
    # weight; K1's two bf16 products and K3's int8 one. K9: K10's work on bf16
    # q and k.
    def beside(name, fused, parts, what):
        a = [cuda_ms(fused), cuda_ms(parts), cuda_ms(parts), cuda_ms(fused)]
        times[name]["fuses"] = what
        times[name]["fuses_ms"] = min(a[1], a[2])
        log(f"  {name} in turns with {what}: fused {a[0]:.3f}/{a[3]:.3f} ms, "
            f"{what} {a[1]:.3f}/{a[2]:.3f} ms")

    beside("K12", table["K12"][1], _k12_calls(t)[2], "K3 + K4")
    # K12 and K3 -> K4 by CUDA graphs in turns (K12, pair, pair, K12), at the
    # exact slice's rows and the filtered stream's
    times["K12"]["graphs_in_turns"] = {}
    for Nk in (N, 481):
        tk = t if Nk == N else _int8_inputs(B, Nk, D, Fh, g)
        fused, _, pair = _k12_calls(tk)
        a = [graph_ms(fused), graph_ms(pair), graph_ms(pair), graph_ms(fused)]
        times["K12"]["graphs_in_turns"][f"N{Nk}"] = {"K12": [a[0], a[3]], "K3 + K4": a[1:3]}
        log(f"  K12 B{B} N{Nk} by CUDA graphs in turns with K3 -> K4: K12 {a[0]:.4f}/{a[3]:.4f} "
            f"ms, K3 -> K4 {a[1]:.4f}/{a[2]:.4f} ms (x{(a[0] + a[3]) / (a[1] + a[2]):.2f})")
    a11 = _k11_inputs(B, N, H, g)
    q, k, v = a11[:3]
    record("K11", f"B{B} N{N} H{H} bf16",
           lambda: FA.flash_attention_packed_out_res(*a11, 0.125, H),
           lambda: FA.flash_attention_packed_out_res_plain(*a11, 0.125, H),
           bound(5 * act + D * D + 12 * D, {"bf16": 4 * B * N * N * D, "int8": 2 * M * D * D}))
    beside("K11", lambda: FA.flash_attention_packed_out_res(*a11, 0.125, H),
           lambda: IB.int8_out_residual(FA.flash_attention_packed(q, k, v, 0.125, H),
                                        *a11[3:]), "K1 + K3")
    # K11 and K1 -> K3 by CUDA graphs in turns (K11, pair, pair, K11), at the
    # exact slice's rows and the filtered streams'
    times["K11"]["graphs_in_turns"] = {}
    for Nk in (N, 481, 257):
        an = a11 if Nk == N else _k11_inputs(B, Nk, H, g)
        fused = (lambda an=an: FA.flash_attention_packed_out_res(*an, 0.125, H))
        pair = (lambda an=an: IB.int8_out_residual(
            FA.flash_attention_packed(*an[:3], 0.125, H), *an[3:]))
        a = [graph_ms(fused), graph_ms(pair), graph_ms(pair), graph_ms(fused)]
        times["K11"]["graphs_in_turns"][f"N{Nk}"] = {"K11": [a[0], a[3]], "K1 + K3": a[1:3]}
        log(f"  K11 B{B} N{Nk} by CUDA graphs in turns with K1 -> K3: K11 {a[0]:.4f}/{a[3]:.4f} "
            f"ms, K1 -> K3 {a[1]:.4f}/{a[2]:.4f} ms (x{(a[0] + a[3]) / (a[1] + a[2]):.2f})")
    for Nk in (N, 481):
        qn, kn, vn = (_rand((B, Nk, D), g, torch.bfloat16) for _ in range(3))
        half = 2 * B * Nk * Nk * D
        record("K9", f"B{B} N{Nk} H{H} bf16",
               lambda: FA.flash_attention_packed_int8(qn, kn, vn, 0.125, H),
               lambda: FA.flash_attention_packed_int8_plain(qn, kn, vn, 0.125, H),
               bound(4 * B * Nk * D * 2, {"int8": half, "bf16": half}))
        beside("K9", lambda: FA.flash_attention_packed_int8(qn, kn, vn, 0.125, H),
               lambda: FA.flash_attention_packed(qn, kn, vn, 0.125, H), "K1")
        times["K9"]["k10_ms"] = cuda_ms(
            lambda: FA.flash_attention_packed_i8qk(qn, kn, vn, 0.125, H))
        times["K9"]["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads(qn), heads(kn), heads(vn), scale=0.125)) if Nk == N else None
        log(f"  K9 beside K10 with its quantising launch {times['K9']['k10_ms']:.3f} ms"
            + (f", scaled_dot_product_attention (not quantised) {times['K9']['sdpa_ms']:.3f} ms"
               if Nk == N else ""))
        # K9 and K10 by CUDA graphs in turns: each attention kernel alone on q
        # and k quantised once (K9 per (row, head), K10 per row), and each
        # wrapper with its quantising launch
        q8h, sqh, k8h, skh = FA.quantize_heads(qn, H, kn)
        q8r, sqr, k8r, skr = FA.quantize_rows(qn, kn)
        runs = [("K10 kernel", lambda: FA._launch_i8qk_kernel(q8r, sqr, k8r, skr, vn, None,
                                                              0.125, H)),
                ("K9 kernel", lambda: FA._launch_i8qk_kernel(q8h, sqh, k8h, skh, vn, None, 0.125,
                                                             H, head_scales=True)),
                ("K9", lambda: FA.flash_attention_packed_int8(qn, kn, vn, 0.125, H)),
                ("K10", lambda: FA.flash_attention_packed_i8qk(qn, kn, vn, 0.125, H))]
        dev = {n: [] for n, _ in runs}
        for n, fn in runs + runs[::-1]:
            dev[n].append(graph_ms(fn))
        times["K9"]["graphs_in_turns"] = dev
        times["K9"]["device_ms"] = sum(dev["K9"]) / 2
        log(f"  K9 B{B} N{Nk} H{H} by CUDA graphs in turns with K10: " + ", ".join(
            f"{n} {v[0]:.4f}/{v[1]:.4f} ms" for n, v in dev.items())
            + f"; K9's kernel x{sum(dev['K9 kernel']) / sum(dev['K10 kernel']):.2f} K10's")
        # Qh: bf16 q and k read, int8 and the f32 (row, head) scales written
        record("Qh", f"B{B} N{Nk} D{D} bf16, q and k", lambda: FA.quantize_heads(qn, H, kn),
               lambda: FA.quantize_heads_plain(qn, H, kn),
               bound(2 * (3 * B * Nk * D + 4 * B * Nk * H), 0, "bf16"))
        times["Qh"]["device_ms"] = graph_ms(lambda: FA.quantize_heads(qn, H, kn))
        log(f"  Qh device time by CUDA graphs: {times['Qh']['device_ms']:.4f} ms")
        if Nk == N:
            k9_main, qh_main = times.pop("K9"), times.pop("Qh")
    times["K9"] = {**k9_main, "other_shape": times["K9"]}
    times["Qh"] = {**qh_main, "other_shape": times["Qh"]}
    return times


def phase_fused_times(int8, filtered_1, x0):
    """The int8 exact and ``2:0.35`` forwards with ``CAIM_FUSE_AOMLP`` off and
    on, in turns; and the 12 hand-assembled blocks through K1 + K3, K11 and K9."""
    import contextlib

    import torch

    from cognitive_aim_tpu_torch.core.rng import NoiseMode

    g = torch.Generator(device="cuda").manual_seed(7)
    x = _rand((8, 518, 518, 3), g, torch.float32)
    gidx = torch.arange(8, device="cuda")
    for name, model in (("int8 exact", int8), ("int8 2:0.35", filtered_1)):
        ms = {False: [], True: []}
        for fuse in (False, True, True, False):
            with _fuse_aomlp() if fuse else contextlib.nullcontext():
                ms[fuse].append(cuda_ms(
                    lambda: model(x, guidance=gidx, noise_mode=NoiseMode.ZEROS),
                    iters=10, warmup=2))
        log(f"  forward B8 518x518 guided, {name}: K3 + K4 {ms[False][0]:.2f}/{ms[False][1]:.2f} "
            f"ms, K12 (CAIM_FUSE_AOMLP=1) {ms[True][0]:.2f}/{ms[True][1]:.2f} ms "
            f"(order off, on, on, off)")
    order = ("split", "K11", "K9", "K9", "K11", "split")
    ms = {r: [] for r in order}
    for route in order:
        ms[route].append(cuda_ms(lambda: _block_chain(int8, x0, route), iters=10, warmup=2))
    log("  12 chained int8 blocks assembled by hand on " + str(tuple(x0.shape)) + ": "
        + ", ".join(f"{'K1 + K3' if r == 'split' else r} {ms[r][0]:.2f}/{ms[r][1]:.2f} ms"
                    for r in ("split", "K11", "K9")) + " (there and back)")


def phase_forward_times(default, int8, filtered=None, adapters=None):
    """The B=8 guided forward under both policies, device and host; with
    ``filtered`` (slice name -> model) also the int8 filtered slices beside
    the unfiltered int8 forward of the same run; with ``adapters`` (slice
    name -> model) the int8 forward with live adapters (the unchained block)
    and the folded filtered slices beside the exact int8 forward."""
    import torch

    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.models.config import token_filter_spec

    g = torch.Generator(device="cuda").manual_seed(7)
    x = _rand((8, 518, 518, 3), g, torch.float32)
    gidx = torch.arange(8, device="cuda")
    fw = []
    for name, model in (("default", default), ("int8", int8), ("int8", int8),
                        ("default", default)):
        fw.append((name, cuda_ms(
            lambda: model(x, guidance=gidx, noise_mode=NoiseMode.ZEROS), iters=10, warmup=2)))
    host = {name: _host_enqueue_ms(
        lambda: model(x, guidance=gidx, noise_mode=NoiseMode.ZEROS))
        for name, model in (("default", default), ("int8", int8))}
    d = [ms for n, ms in fw if n == "default"]
    i8 = [ms for n, ms in fw if n == "int8"]
    log(f"  forward B8 518x518 guided, kernels: default policy {d[0]:.2f}/{d[1]:.2f} ms, "
        f"int8 policy {i8[0]:.2f}/{i8[1]:.2f} ms (order default, int8, int8, default); "
        f"{8e3 / min(d):.1f} img/s default, {8e3 / min(i8):.1f} img/s int8")
    log(f"  host time to enqueue one forward: default {host['default']:.2f} ms, "
        f"int8 {host['int8']:.2f} ms")
    busy = {name: device_busy_ms(lambda m=model: m(x, guidance=gidx, noise_mode=NoiseMode.ZEROS))
            for name, model in (("int8", int8), ("default", default))}
    log(f"  device time of one forward (torch.profiler, kernels summed): exact int8 "
        f"{busy['int8']:.3f} ms, exact default {busy['default']:.3f} ms")
    default.attn_impl = "plain"
    plain_ms = cuda_ms(lambda: default(x, guidance=gidx, noise_mode=NoiseMode.ZEROS),
                       iters=5, warmup=1)
    default.attn_impl = "pallas_packed"
    log(f"  forward B8 518x518 guided, default policy through the plain versions: "
        f"{plain_ms:.2f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {peak:.2f} GiB")
    def in_turns(run):
        """Each model's forward timed twice, there and back again."""
        order = list(run) + list(run)[::-1]
        log(f"  in turns: {', '.join(order)}")
        ms = {n: [] for n in run}
        for n in order:
            ms[n].append(cuda_ms(
                lambda m=run[n]: m(x, guidance=gidx, noise_mode=NoiseMode.ZEROS),
                iters=10, warmup=2))
        for n, m in run.items():
            enq = _host_enqueue_ms(lambda m=m: m(x, guidance=gidx, noise_mode=NoiseMode.ZEROS))
            spec = f"{token_filter_spec(m.arch) or 'no filter'}, {m.attn_impl}"
            lora = (f", adapters rank {m.arch.lora_rank} "
                    f"{'live' if m.backbone.layers[0].live_adapters else 'folded'}"
                    if m.arch.use_lora else "")
            log(f"  forward B8 518x518 guided, {n} ({spec}{lora}): "
                f"{ms[n][0]:.2f}/{ms[n][1]:.2f} ms, {8e3 / min(ms[n]):.1f} img/s; "
                f"host enqueue {enq:.2f} ms")

    if filtered:  # the filtered slices beside the unfiltered int8 forward
        in_turns({"int8 unfiltered": int8,
                  **{f"int8 slice {n}": m for n, m in filtered.items() if n != "4"}})
    if adapters:  # live adapters (unchained) and the folded deployments beside exact int8
        in_turns({"int8 exact": int8, "default exact": default,
                  **{f"slice {n}": m for n, m in adapters.items()}})


# ------------------------------------------------------------ serving (f) ----
SERVE_CONFIG = "eval_configs/full_cognitive_fast_tpu.yaml"
SERVE_MAX_BATCH = 8
SERVE_DIR = os.path.join(ROOT, "build", "smoke_serving")  # listed in .gitignore


def host_packages():
    """What the host offers the serving path: PIL (request decode, image
    files), PyYAML (the config), matplotlib (prediction PNGs) and the native
    loader's build (g++ with the libjpeg / libpng headers)."""
    from cognitive_aim_tpu_torch.io import native_loader

    found = {}
    for name in ("PIL", "yaml", "matplotlib"):
        try:
            found[name] = __import__(name).__version__
        except ImportError:
            found[name] = None
    found["g++"] = shutil.which("g++")
    found["native loader"] = "built" if native_loader.available() else None
    found["native loader error"] = native_loader.build_error
    return found


def _serving_configs(raw):
    """Two copies of the config as JSON files (JSON is YAML): exact, without
    the token_filter_* keys, and fast, the config's own 2:0.35 with
    token_filter_fuse. Both drop use_lora: the config's live rank-16
    adapters would run the unchained int8 block (K15), and the main path
    bench.py times builds its model without adapters."""
    import copy

    fast = copy.deepcopy(raw)
    for d in (fast, fast.get("model", {})):
        d["use_lora"] = False
    exact = copy.deepcopy(fast)
    for d in (exact, exact.get("model", {})):
        for k in [k for k in d if k.startswith("token_filter")]:
            del d[k]
    paths = {}
    for name, cfg in (("exact", exact), ("fast", fast)):
        paths[name] = os.path.join(SERVE_DIR, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


def _png_b64(rng, h, w):
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _image_files(rng, n):
    """n JPEGs of seeded pixels under SERVE_DIR/images, every other one with
    an EXIF block (focal length, f-number, ISO)."""
    from PIL import Image

    root = os.path.join(SERVE_DIR, "images")
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        img = Image.fromarray(rng.randint(0, 256, (480 + 8 * i, 640, 3), dtype=np.uint8))
        p = os.path.join(root, f"im{i}.jpg")
        if i % 2:
            ex = Image.Exif()
            ex[272] = "SmokeCam"
            sub = ex.get_ifd(0x8769)
            sub[37386], sub[33437], sub[34855] = 24.0 + i, 2.0 + 0.1 * i, 200 * (i + 1)
            img.save(p, "JPEG", quality=95, exif=ex)
        else:
            img.save(p, "JPEG", quality=95)
        paths.append(p)
    return root, paths


def _http(url, payload=None, timeout=120):
    """(status, body, seconds) of one request."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def _concurrently(fn, args, threads):
    """fn(arg) for every arg from a pool of threads; results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(fn, args))


def _engine_reference(engine, decoded, gidx):
    """The engine's own batched forward of decoded requests, in batches of
    SERVE_MAX_BATCH: (depth [n], confidence [n])."""
    import torch

    depth, conf = [], []
    for s in range(0, len(decoded), SERVE_MAX_BATCH):
        part = decoded[s:s + SERVE_MAX_BATCH]
        x = torch.from_numpy(np.stack([img for img, _ in part])).to(engine.device)
        e = engine._to_device({k: np.asarray([ex[k] for _, ex in part]) for k in part[0][1]})
        out = engine._forward(x, e, engine._guidance(gidx[s:s + SERVE_MAX_BATCH]))
        depth.append(out.depth[:, 0].cpu().numpy())
        conf.append(out.confidence[:, 0].cpu().numpy())
    return np.concatenate(depth), np.concatenate(conf)


def _relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max())


class _attention_lengths:
    """Record the token count of every attention call of the backbone."""

    def __enter__(self):
        from cognitive_aim_tpu_torch.nn import dinov2

        self.seen, self.module, self.orig = [], dinov2, dinov2.attend

        def spy(attn_impl, q, *rest):
            self.seen.append(int(q.shape[1]))
            return self.orig(attn_impl, q, *rest)

        dinov2.attend = spy
        return self

    def __exit__(self, *exc):
        self.module.attend = self.orig


def _serve_engine(tag, engine, smi, rng, image_root, image_paths):
    """Serve one engine on loopback and drive it: /healthz, 24 concurrent
    /predict with mixed instructions, one /predict_batch of 10 server-local
    paths (a padded tail chunk), one bad request, the launches of one served
    forward, then a timed load. Returns the load's numbers."""
    import torch

    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS
    from cognitive_aim_tpu_torch.serve import _decode_request_image, serve, stage_ms

    wrappers = _wrappers()
    engine.compiled.graphs.clear()  # the server's warm-up captures its graph anew
    t0 = time.perf_counter()
    # the warm-up captures the one max_batch graph: the spy sees its warm-up
    # forward and the captured one (a replay runs no Python)
    with _attention_lengths() as k1n:
        httpd, batcher = serve(engine, port=0, max_batch=SERVE_MAX_BATCH, max_delay_ms=5.0,
                               data_root=image_root)
    warm_s = time.perf_counter() - t0
    held = engine.compiled.describe()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, health, _ = _http(base + "/healthz")
        if code != 200 or health["max_batch"] != SERVE_MAX_BATCH:
            raise AssertionError(f"{tag}: /healthz answered {code} {health}")
        first = {"image_b64": _png_b64(rng, 480, 640), "instruction": "top-left"}
        code, body, first_s = _http(base + "/predict", first)
        if code != 200:
            raise AssertionError(f"{tag}: first /predict answered {code} {body}")
        # the same request alone once more: what the first paid beyond it is
        # one-time work the warmup left
        _, _, second_s = _http(base + "/predict", first)
        # the launches of one served forward, one request driving: read from
        # the trace of its replay against the captured forward run eagerly
        (entry,) = engine.compiled.graphs.values()
        gen = None if entry.generator is None else torch.Generator(engine.device).manual_seed(0)
        (code, body, _), counts, n_kernels = _replay_launches(
            f"{tag}: a served forward", lambda: engine._compiled_fn(entry.inputs, gen),
            lambda: _http(base + "/predict", first), wrappers)
        launches = {k: n for k, n in counts.items() if n}
        if code != 200:
            raise AssertionError(f"{tag}: the third /predict answered {code} {body}")
        layers = engine.model.vit_cfg.num_layers
        iters = engine.arch.num_iterations
        want = {**{k: layers for k in ("K1", "K2", "K3", "K4", "K4a", "K4b")},
                "K5": iters, "K6": iters}
        # K1 at N 1370 in every block; under 2:0.35 at N 481 after block 2
        # (CLS, round(0.35 x 1369) = 479 kept patches, one fused context token)
        a, P = engine.arch, (engine.image_size // 14) ** 2
        filt = a.token_filter_layer if a.token_filter_active else layers
        kept = 1 + max(1, round(a.token_filter_keep * P)) + \
            (a.token_filter_fuse_k if a.token_filter_fuse else 0)
        lengths = [1 + P] * filt + [kept] * (layers - filt)
        captured = k1n.seen[-layers:]
        log(f"  {tag}: warmup {warm_s:.2f} s before the server took traffic (the max_batch "
            f"graph captured in {held['each'][0]['capture_s']:.2f} s, "
            f"{held['pool_bytes'] / 2 ** 20:.1f} MiB of pool); first /predict "
            f"{first_s * 1e3:.1f} ms, the same request alone again {second_s * 1e3:.1f} ms; "
            f"launches of a served forward (one replay; read from its trace, {n_kernels} "
            f"caim kernels, the captured forward's in its order): "
            + ", ".join(f"{k} {n}" for k, n in launches.items())
            + f"; K1's token count by block in the captured forward {captured}")
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches} != {want}")
        if held["graphs"] != 1 or len(k1n.seen) != 2 * layers or captured != lengths:
            raise AssertionError(f"{tag}: {held['graphs']} graphs after the warm-up; K1 "
                                 f"token counts {k1n.seen} != {lengths} twice")

        # 24 concurrent /predict, mixed instructions, each against the
        # engine's own batched forward of the same pixels
        reqs = [{"image_b64": _png_b64(rng, 360 + 16 * (i % 5), 500 + 20 * (i % 7)),
                 "instruction": INSTRUCTIONS[i % 9]} for i in range(24)]
        answers = _concurrently(lambda p: _http(base + "/predict", p), reqs, 24)
        if any(c != 200 for c, _, _ in answers):
            raise AssertionError(f"{tag}: /predict codes {[c for c, _, _ in answers]}")
        decoded = [_decode_request_image(p, engine) for p in reqs]
        gidx = np.asarray([i % 9 for i in range(24)])
        ref_d, ref_c = _engine_reference(engine, decoded, gidx)
        rd = _relerr([b["depth"] for _, b, _ in answers], ref_d)
        rc = _relerr([b["confidence"] for _, b, _ in answers], ref_c)
        # /predict_batch: 10 server-local paths at max_batch 8 (the tail padded)
        code, body, _ = _http(base + "/predict_batch", {
            "paths": image_paths, "instructions": [INSTRUCTIONS[i % 9] for i in range(10)],
            "batch_size": 3})
        if code != 200 or len(body["results"]) != len(image_paths):
            raise AssertionError(f"{tag}: /predict_batch answered {code}")
        # the loader's pixels (bilinear, no antialias) differ from /predict's PIL
        # resize by design: held against the engine's batched path on the same files
        direct = engine.predict_paths_batched(
            image_paths, instructions=[INSTRUCTIONS[i % 9] for i in range(10)],
            batch_size=SERVE_MAX_BATCH)
        rbd = _relerr([r[0] for r in body["results"]], [d for d, _ in direct])
        rbc = _relerr([r[1] for r in body["results"]], [c for _, c in direct])
        code_bad, bad, _ = _http(base + "/predict", {"instruction": "center"})
        log(f"  {tag}: /healthz ok; 24 concurrent /predict against the engine's batched "
            f"forward: depth rel {rd:.2e}, confidence rel {rc:.2e}; /predict_batch of 10 "
            f"paths (decoder {engine.last_decoder}, chunks of {SERVE_MAX_BATCH}, the tail "
            f"padded) against predict_paths_batched on the same files: depth rel {rbd:.2e}, confidence rel {rbc:.2e} "
            f"(tol {TOL_SLICE_BF16:.0e}); bad request {code_bad}")
        if max(rd, rc, rbd, rbc) > TOL_SLICE_BF16:
            raise AssertionError(f"{tag}: served answers disagree with the engine")
        if code_bad != 400 or "error" not in bad:
            raise AssertionError(f"{tag}: a bad request answered {code_bad}")

        # the timed load: 96 requests from 16 client threads
        load = [{"image_b64": _png_b64(rng, 480, 640), "instruction": INSTRUCTIONS[i % 9]}
                for i in range(96)]
        batcher.batches.clear()
        batcher.decode_ms.clear()
        t0 = time.perf_counter()
        timed = _concurrently(lambda p: _http(base + "/predict", p), load, 16)
        wall = time.perf_counter() - t0
        if any(c != 200 for c, _, _ in timed):
            raise AssertionError(f"{tag}: load codes {[c for c, _, _ in timed]}")
        lat = np.asarray([s for _, _, s in timed]) * 1e3
        batcher.stop()  # every record whole: a batch's reply is written after its answers
        bt = list(batcher.batches)
        stage = stage_ms(bt)
        numbers = {
            "requests_per_s": len(load) / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "first_ms": first_s * 1e3,
            "second_alone_ms": second_s * 1e3,
            "warmup_s": warm_s, "capture_s": held["each"][0]["capture_s"],
            "pool_mib": held["pool_bytes"] / 2 ** 20,
            "decode_ms": float(np.mean(batcher.decode_ms)),
            "batches": len(bt), "mean_batch": float(np.mean([b["n"] for b in bt])), **stage}
        log(f"  {tag}: {len(load)} requests from 16 threads in {wall:.2f} s: "
            f"{numbers['requests_per_s']:.1f} requests/s, latency p50 "
            f"{numbers['p50_ms']:.1f} ms, p99 {numbers['p99_ms']:.1f} ms ({smi})")
        log(f"  {tag}: per stage: host decode + resize {numbers['decode_ms']:.1f} ms a "
            f"request (handler threads); {len(bt)} batches of {numbers['mean_batch']:.2f} on "
            f"average: dispatch {stage['dispatch_ms']:.2f} ms (from_numpy, the engine call); "
            f"the server's records, mean ms: queue wait {stage['queue_wait_ms']:.2f} a request; "
            + ", ".join(f"{k[:-3]} {stage[k]:.2f}" for k in stage
                        if k not in ("dispatch_ms", "queue_wait_ms", "wake_ms"))
            + f" a batch; wake {stage['wake_ms']:.2f} a request")
        return numbers
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()


def phase_serving(smi, packages):
    """(f) the port's engine and server at ViT-B 518 int8, exact and at the
    config's 2:0.35: checkpoint round trip, the stamp check, the served
    answers against the engine's own forward, launches, and the load."""
    import contextlib
    import io

    import torch

    from cognitive_aim_tpu_torch.api import (
        CheckpointRefused,
        CognitiveAimInference,
        load_config,
    )

    log(f"(f) serving: the port's engine and HTTP server, {SERVE_CONFIG}, policy int8, "
        f"pallas_packed, max_batch {SERVE_MAX_BATCH}")
    not_driven = []
    if packages["matplotlib"] is None:
        not_driven.append("prediction PNGs (utils/visualize): matplotlib is not installed; "
                          "the engines run with save_images=False")
    if packages["native loader"] is None:
        not_driven.append("the native C++ loader (io/native_loader): it did not build "
                          f"({packages['native loader error']}); /predict_batch decodes "
                          "with its PIL fallback")
    if packages["yaml"] is None or packages["PIL"] is None:
        not_driven.insert(0, "phase (f): it needs PyYAML for the config and PIL for the "
                             "requests' images")
        for s in not_driven:
            log(f"  not driven: {s}")
        return {"not_driven": not_driven}
    os.makedirs(SERVE_DIR, exist_ok=True)
    cfgs = _serving_configs(load_config(os.path.join(ROOT, SERVE_CONFIG)))
    kw = dict(policy="int8", attn_impl="pallas_packed", noise_mode="zeros",
              save_images=False)
    t0 = time.perf_counter()
    exact = CognitiveAimInference(cfgs["exact"], None, seed=0, **kw)
    torch.cuda.synchronize()
    log(f"  engine (exact) built on {exact.device} in {time.perf_counter() - t0:.1f} s: "
        f"ViT-B {exact.image_size}x{exact.image_size}, "
        f"{exact.arch.num_iterations} focal iterations, token filter off")

    # checkpoint round trip, bit for bit
    npz = os.path.join(SERVE_DIR, "engine.npz")
    exact.save_native_checkpoint(npz)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = CognitiveAimInference(cfgs["exact"], npz, seed=1, **kw)
    dev, S = exact.device, exact.image_size
    x = torch.randn((8, S, S, 3), generator=torch.Generator(dev).manual_seed(11), device=dev)
    exif = {"camera_idx": torch.zeros(8, dtype=torch.long, device=dev),
            "focal_length": torch.full((8,), 50.0, device=dev),
            "aperture": torch.full((8,), 2.8, device=dev),
            "iso": torch.full((8,), 100.0, device=dev)}
    gidx = torch.arange(8, device=dev)
    a, b = exact._forward(x, exif, gidx), again._forward(x, exif, gidx)
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("depth", "confidence", "attention"))
    log(f"  checkpoint round trip ({os.path.getsize(npz) / 2 ** 20:.0f} MiB float32 npz; "
        f"{buf.getvalue().strip()}): depth, confidence and attention of a batch of 8 "
        f"{'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the engine loaded from its own npz gives other outputs")
    del again

    # the 2:0.35 engine from the same npz: unstamped, it warns; required, it raises
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fast = CognitiveAimInference(cfgs["fast"], npz, seed=2, **kw)
    warned = "WARNING: token filter '2:0.35' is active" in buf.getvalue() \
        and "carries no train-filter stamp" in buf.getvalue()
    saved = os.environ.get("CAIM_REQUIRE_FILTER_STAMP")
    os.environ["CAIM_REQUIRE_FILTER_STAMP"] = "1"
    try:
        CognitiveAimInference(cfgs["fast"], npz, seed=2, **kw)
        refused = False
    except CheckpointRefused:
        refused = True
    finally:
        if saved is None:
            del os.environ["CAIM_REQUIRE_FILTER_STAMP"]
        else:
            os.environ["CAIM_REQUIRE_FILTER_STAMP"] = saved
    log(f"  engine (2:0.35, token_filter_fuse) from the same npz: unstamped-checkpoint "
        f"warning {'printed' if warned else 'MISSING'}; with CAIM_REQUIRE_FILTER_STAMP=1 "
        f"{'raised CheckpointRefused' if refused else 'did NOT raise'}")
    if not (warned and refused):
        raise AssertionError("the filter stamp check did not warn and refuse")
    os.remove(npz)

    rng = np.random.RandomState(5)
    image_root, image_paths = _image_files(rng, 10)
    numbers = {}
    for tag, engine in (("exact", exact), ("2:0.35", fast)):
        numbers[tag] = _serve_engine(tag, engine, smi, rng, image_root, image_paths)
    for s in not_driven:
        log(f"  not driven: {s}")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (f) imported JAX or the JAX package: {foreign}")
    return {**numbers, "not_driven": not_driven}


# ------------------------------------------------------------ training (g) ----
TRAIN_CONFIG = os.path.join("configs", "experiment_B.yaml")
# the gradient check of a training step on experiment_B.yaml's ViT-B at batch
# 128, kernels against plain versions on one batch and one set of weights. The
# backward is the same plain recompute on both routes, so the forwards' rounding
# is all that differs. In float32 (tanh GELU, as the default policy) that is
# summation order: each parameter's gradient within 1e-4 (relative L2; measured
# 6.5e-6 at worst on the card), where the parameter holds at least 1e-6 of the
# global gradient norm. Below that share the gradients are analytically zero (the
# focal curiosity modulators and adaptive weights, which the per-row
# renormalisation cancels; the focal key biases, which softmax's shift invariance
# cancels) and only rounding is left: |difference| <= 1e-6 of the global norm.
TOL_TRAIN_GRAD_F32 = 1e-4
TRAIN_GRAD_FLOOR = 1e-6
# In bf16, the trained policy, each route is ~2e-2 (median) from the float32
# gradient, up to 0.12 for the patch embedding: the plain version rounds the
# scores to bf16, the kernels P. So: the global relative L2 of kernels against
# plain and the loss within 2e-2 (measured 1.4e-2, 6.8e-5), and per parameter the
# kernel route's distance to the float32 gradient at most twice the plain
# route's own plus 1e-2 (measured ratio <= 1.64)
TOL_TRAIN_GRAD = 2e-2
TRAIN_GRAD_RATIO = 2.0
# the trained checkpoint served by the port's engine against the trainer's own
# eval forward on a val batch: one set of bf16 weights, cast once against cast
# at each call, one program: bit-equal in practice
TOL_TRAIN_SERVE = 1e-5


def _gradless_calls():
    """Each kernel wrapper without a backward, on a small CUDA input that
    requires grad: it must raise before it launches anything."""
    import torch

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG
    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight

    B, N, D, F, H = 1, 64, 128, 256, 2
    g = torch.Generator(device="cuda").manual_seed(11)

    def w8(n, k):
        w = quantize_weight(torch.randn(n, k, generator=g, device="cuda"))
        return w["q"], w["s"]

    def f(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    ln, ls = (torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")), f(D)
    wqkv, wo, w1, w2 = w8(3 * D, D), w8(D, D), w8(F, D), w8(D, F)
    h8 = torch.zeros(B, N, F, dtype=torch.int8, device="cuda")
    sh = torch.ones(B, N, 1, device="cuda")
    return {
        "K2": lambda x: IB.int8_qkv_proj_ln(x, *ln, *wqkv, f(3 * D)),
        "K3": lambda x: IB.int8_out_residual(x, *wo, f(D), ls, x),
        "K4": lambda x: IB.int8_mlp_ln(x, *ln, *w1, f(F), *w2, f(D), ls),
        "K4a": lambda x: IB.int8_fc1_gelu_ln(x, *ln, *w1, f(F)),
        "K4b": lambda x: IB.int8_out_residual_prequant(h8, sh, *w2, f(D), ls, x),
        "K5": lambda x: IB.int8_qkv_proj(x, *wqkv, f(3 * D)),
        "K8": lambda x: FA.flash_attention(*(x.view(B, N, H, D // H),) * 3, 0.125),
        "K11": lambda x: FA.flash_attention_packed_out_res(x, x, x, *wo, f(D), ls, x, 0.125, H),
        "K12": lambda x: IB.int8_attnout_mlp_ln(x, *wo, f(D), ls, x, *ln, *w1, f(F), *w2,
                                                f(D), ls),
        "K13": lambda x: IB.int8_proj(x, *wqkv, f(3 * D)),
        "K14": lambda x: IB.int8_fc1_gelu(x, *w1, f(F)),
        "K15": lambda x: IG.int8_gemm_fused(x[0], *wqkv, f(3 * D)),
        "Q": lambda x: FA.quantize_rows(x, x),
        "Qh": lambda x: FA.quantize_heads(x, H, x),
    }, f(B, N, D).to(torch.bfloat16)


def _train_batch(B, S, g):
    """A device batch of the trainer's schema: normalised images, per-image
    depths, the dataset's normalised EXIF."""
    import torch

    return {"images": torch.randn(B, S, S, 3, generator=g, device="cuda"),
            "depths": torch.rand(B, S, S, generator=g, device="cuda"),
            "exif": {"camera_idx": torch.zeros(B, dtype=torch.int32, device="cuda"),
                     "focal_length": torch.full((B,), 0.25, device="cuda"),
                     "aperture": torch.full((B,), 0.127, device="cuda"),
                     "iso": torch.full((B,), 0.016, device="cuda")}}


def _write_dataset(root, n_train, n_val, size, seed):
    """PNGs of smooth random fields and their depth maps (.npy), listed in
    train/val annotation files, from a numpy seed."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depths"))
    anns = {"train": [], "val": []}
    for i in range(n_train + n_val):
        coarse = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
        img = Image.fromarray(coarse).resize((size, size), Image.BILINEAR)
        ip = os.path.join(root, "images", f"im{i:04d}.png")
        dp = os.path.join(root, "depths", f"im{i:04d}_depth.npy")
        img.save(ip)
        np.save(dp, (rng.rand(size // 4, size // 4) * 9 + 1).astype(np.float32))
        split = "train" if i < n_train else "val"
        anns[split].append({"image_path": ip, "depth_path": dp, "image_id": i})
    for split, a in anns.items():
        with open(os.path.join(root, f"{split}_annotations.json"), "w") as f:
            json.dump(a, f)


def _grad_check(raw, arch, wrappers, B):
    """Gradients of the trainer's loss on one batch (dropout off, noise 0)
    through the kernels and through the plain versions, under the default
    policy and in float32; the launches of one micro-step with and without
    per-block recompute."""
    import torch

    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY, Policy
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    g = torch.Generator(device="cuda").manual_seed(5)
    kern = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed").init(g)
    with torch.no_grad():  # lora_B 0 (its init) would leave lora_A's gradient 0
        for blk in kern.backbone.layers:
            blk.lora_B.normal_(0.0, 0.02, generator=g)
    batch = _train_batch(B, arch.image_size, g)
    cfg = TrainConfig.from_raw(raw, steps_per_epoch=4)
    out_dir = os.path.join(ROOT, "build", "smoke_training", "grad")
    n_layers, n_iters = kern.vit_cfg.num_layers, arch.num_iterations
    f32 = Policy(backbone_compute_dtype=torch.float32, fast_gelu=True)  # default's GELU
    routes = (("kernels", DEFAULT_POLICY, "pallas_packed"), ("plain", DEFAULT_POLICY, "plain"),
              ("f32_kernels", f32, "pallas_packed"), ("f32_plain", f32, "plain"))
    losses, grads, counts = {}, {}, {}
    for name, policy, impl in routes:
        model = kern
        if name != "kernels":
            model = CognitiveAimModel(arch, policy, impl)
            model.load_state_dict(kern.state_dict())
        tr = Trainer(model, cfg, output_dir=out_dir)
        for remat in (("1", "0") if name == "kernels" else ("1",)):
            os.environ["CAIM_TRAIN_REMAT"] = remat
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            total, _ = tr.loss(model, batch, None, *tr.step_inputs())
            got = torch.autograd.grad(total, [p for _, p in tr._trainable], allow_unused=True)
            torch.cuda.synchronize()
            counts[f"{name}_remat{remat}"] = {k: w.launches for k, w in wrappers.items()}
            if remat == "1":
                losses[name] = float(total.detach())
                grads[name] = {n: (torch.zeros_like(p) if gr is None else gr).float()
                               for (n, p), gr in zip(tr._trainable, got)}
        os.environ.pop("CAIM_TRAIN_REMAT", None)
        if model is not kern:
            del model
    kernel_route = {"K1": 2 * n_layers, "K6": n_iters}
    want = {"kernels_remat1": kernel_route, "kernels_remat0": {"K1": n_layers, "K6": n_iters},
            "plain_remat1": {}, "f32_kernels_remat1": kernel_route, "f32_plain_remat1": {}}
    for run, c in counts.items():
        expect = {k: want[run].get(k, 0) for k in wrappers}
        log(f"  {run}: launches in one micro-step: K1 {c['K1']}, K6 {c['K6']} "
            f"(want {expect['K1']}, {expect['K6']}; every other kernel 0)")
        if c != expect:
            raise AssertionError(f"training launches {run}: {c} != {expect}")

    def norm(d, n):
        return float(d[n].norm())

    def diff(a, b, n):
        return float((grads[a][n] - grads[b][n]).norm())

    ref = grads["f32_plain"]
    names = list(ref)
    total_norm = float(np.sqrt(sum(norm(ref, n) ** 2 for n in names)))
    live = [n for n in names if norm(ref, n) >= TRAIN_GRAD_FLOOR * total_norm]
    # float32: the backward contract, to rounding
    f32_rel = {n: diff("f32_kernels", "f32_plain", n) / norm(ref, n) for n in live}
    f32_dead = max((diff("f32_kernels", "f32_plain", n) / total_norm
                    for n in names if n not in live), default=0.0)
    f32_loss = abs(losses["f32_kernels"] - losses["f32_plain"]) / abs(losses["f32_plain"])
    worst32 = max(f32_rel, key=f32_rel.get)
    log(f"  float32: loss rel {f32_loss:.2e}; {len(live)} gradients of >= "
        f"{TRAIN_GRAD_FLOOR:.0e} of the global norm: worst rel L2 {f32_rel[worst32]:.2e} "
        f"({worst32}; tol {TOL_TRAIN_GRAD_F32:.0e}); the {len(names) - len(live)} others "
        f"(analytically zero): worst |difference| {f32_dead:.2e} of the global norm")
    if (f32_rel[worst32] > TOL_TRAIN_GRAD_F32 or f32_dead > TRAIN_GRAD_FLOOR
            or f32_loss > TOL_TRAIN_GRAD_F32):
        raise AssertionError(f"float32 kernel-path gradients disagree with the plain path: "
                             f"{worst32} {f32_rel[worst32]:.2e}, dead {f32_dead:.2e}")
    # bf16: the trained policy
    kp = {n: diff("kernels", "plain", n) / max(norm(grads["plain"], n), 1e-30) for n in live}
    glob = float(np.sqrt(sum(diff("kernels", "plain", n) ** 2 for n in names)
                         / sum(norm(grads["plain"], n) ** 2 for n in names)))
    loss_rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    ek = {n: diff("kernels", "f32_plain", n) / norm(ref, n) for n in live}
    ep = {n: diff("plain", "f32_plain", n) / norm(ref, n) for n in live}
    excess = {n: ek[n] - (TRAIN_GRAD_RATIO * ep[n] + 1e-2) for n in live}
    worst = max(excess, key=excess.get)
    ratio = max(ek[n] / ep[n] for n in live)
    over = sum(v > TOL_TRAIN_GRAD for v in kp.values())
    log(f"  bf16: loss kernels {losses['kernels']:.6f} plain {losses['plain']:.6f} (rel "
        f"{loss_rel:.2e}); gradients kernels vs plain: global rel L2 {glob:.2e} (tol "
        f"{TOL_TRAIN_GRAD:.0e}), per parameter median {float(np.median(list(kp.values()))):.2e}"
        f", worst {max(kp.values()):.2e} ({max(kp, key=kp.get)}), {over} of {len(live)} over "
        f"{TOL_TRAIN_GRAD:.0e}; to the float32 gradient: kernels median "
        f"{float(np.median(list(ek.values()))):.2e}, plain median "
        f"{float(np.median(list(ep.values()))):.2e}, worst ratio {ratio:.2f} "
        f"(kernels <= {TRAIN_GRAD_RATIO:.0f} x plain + 1e-2: worst {worst} "
        f"{ek[worst]:.2e} vs {ep[worst]:.2e})")
    if glob > TOL_TRAIN_GRAD or loss_rel > TOL_TRAIN_GRAD or excess[worst] > 0:
        raise AssertionError(f"bf16 kernel-path gradients disagree with the plain path: "
                             f"global {glob:.2e}, loss {loss_rel:.2e}, {worst} "
                             f"{ek[worst]:.2e} vs {ep[worst]:.2e}")
    del grads, ref
    return kern, batch, {
        "loss_rel_err": loss_rel, "grad_global_rel_l2": glob,
        "grad_rel_l2_median": float(np.median(list(kp.values()))),
        "grad_rel_l2_worst": max(kp.values()), "grad_rel_l2_worst_param": max(kp, key=kp.get),
        "grad_params_over_2e-2": over, "n_params_checked": len(live),
        "n_params_analytically_zero": len(names) - len(live),
        "to_f32_kernels_median": float(np.median(list(ek.values()))),
        "to_f32_plain_median": float(np.median(list(ep.values()))),
        "to_f32_worst_ratio": ratio,
        "f32_loss_rel_err": f32_loss, "f32_grad_rel_l2_worst": f32_rel[worst32],
        "f32_grad_rel_l2_worst_param": worst32, "f32_dead_abs_worst": f32_dead,
        "launches_per_micro_step": {run: {"K1": c["K1"], "K6": c["K6"]}
                                    for run, c in counts.items()}}


def _graph_kinds(tr):
    """(micro-step graphs, eval forward graphs) a trainer holds."""
    from cognitive_aim_tpu_torch.train.trainer import StepKey

    keys = [k for k, _ in tr.graphs.graphs]
    steps = sum(isinstance(k, StepKey) for k in keys)
    return steps, len(keys) - steps


def _step_times(model, raw, batch, B):
    """The eager micro-step's time (median of the steps after the first,
    CUDA events), images/s and peak memory, with per-block recompute on and
    off (phase (l) times the captured step); one eager step
    under torch.profiler: K1's and K6's forward kernels and the plain
    recompute of the attention backward; SDPA forward + backward at K1's
    shape as a yardstick."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    out = {}
    cfg = TrainConfig.from_raw(raw, steps_per_epoch=4)
    tr = Trainer(model, cfg, output_dir=os.path.join(ROOT, "build", "smoke_training", "t"))
    gen = torch.Generator(device="cuda").manual_seed(9)
    for remat in ("1", "0"):
        os.environ["CAIM_TRAIN_REMAT"] = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            tr.train_step(batch, gen, fetch_logs=False, eager=True)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times[1:]))
        out[f"remat_{'on' if remat == '1' else 'off'}"] = {
            "micro_step_ms": ms, "micro_step_ms_all": times,
            "images_per_s": B / ms * 1e3,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    os.environ["CAIM_TRAIN_REMAT"] = "1"
    tr.train_step(batch, gen, fetch_logs=False, eager=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(batch, gen, fetch_logs=False, eager=True)
        torch.cuda.synchronize()
    os.environ.pop("CAIM_TRAIN_REMAT", None)
    # kernels only: the recompute's record_function ranges sit on the device timeline too
    dev = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.name.startswith("recompute_vjp")]
    busy = sum(t for _, t in dev)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    k1 = [t for n, t in dev if "flash_wgmma_kernel" in n]
    k6 = [t for n, t in dev if "focal_wgmma_kernel" in n or "focal_colmean_kernel" in n]

    def range_ms(label):
        for e in prof.key_averages():
            if e.key == label:
                return (getattr(e, "device_time_total", 0) or
                        getattr(e, "cuda_time_total", 0)) / 1e3
        return None

    out["profiled_micro_step"] = {
        "device_busy_ms": busy, "K1_forward_ms": sum(k1), "K1_kernels": len(k1),
        "K6_forward_ms": sum(k6), "K6_kernels": len(k6),
        "K1_backward_plain_recompute_ms": range_ms(
            "recompute_vjp flash_attention_packed_plain"),
        "K6_backward_plain_recompute_ms": range_ms("recompute_vjp focal_attention_plain")}

    # one K1 call at the training shape: kernel forward, forward + backward
    # (the plain recompute), plain forward + backward, SDPA forward + backward
    g = torch.Generator(device="cuda").manual_seed(13)
    N, H, Dh = (model.arch.image_size // 14) ** 2 + 1, 12, 64
    q, k, v, go = (torch.randn(B, N, H * Dh, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)

    def fb(fn):
        return lambda: torch.autograd.grad(fn(), (q, k, v), go)

    def sdpa():
        o = F.scaled_dot_product_attention(*(t.view(B, N, H, Dh).transpose(1, 2)
                                              for t in (q, k, v)))
        return o.transpose(1, 2).reshape(B, N, H * Dh)

    with torch.no_grad():
        k1_fwd = cuda_ms(lambda: FA.flash_attention_packed(q, k, v, Dh ** -0.5, H))
    k1_fb = cuda_ms(fb(lambda: FA.flash_attention_packed(q, k, v, Dh ** -0.5, H)))
    plain_fb = cuda_ms(fb(lambda: FA.flash_attention_packed_plain(q, k, v, Dh ** -0.5, H)))
    sdpa_fb = cuda_ms(fb(sdpa))
    P, D = N - 1, model.feature_dim
    fq, fk, fv = (torch.randn(B, P, D, generator=g, device="cuda", dtype=torch.bfloat16)
                  .requires_grad_(True) for _ in range(3))
    with torch.no_grad():
        k6_fwd = cuda_ms(lambda: FO.focal_attention_fused(fq, fk, fv, (D // 8) ** 0.5))
    k6_fb = cuda_ms(lambda: torch.autograd.grad(
        FO.focal_attention_fused(fq, fk, fv, (D // 8) ** 0.5)[0], (fq, fk, fv), fq))
    out["attention_at_training_shape"] = {
        "K1_shape": [B, N, H * Dh], "K1_forward_ms": k1_fwd,
        "K1_forward_backward_ms": k1_fb, "K1_backward_ms": k1_fb - k1_fwd,
        "plain_forward_backward_ms": plain_fb, "sdpa_forward_backward_ms": sdpa_fb,
        "K6_shape": [B, P, D], "K6_forward_ms": k6_fwd, "K6_forward_backward_ms": k6_fb,
        "K6_backward_ms": k6_fb - k6_fwd}
    return out


def phase_training(smi):
    """(g) training on the card: experiment_B.yaml (ViT-B/14 at 224, LoRA rank
    16 on attn_out, everything trainable, 6 focal iterations, batch 128,
    accumulation 4), the default policy, attn_impl="pallas_packed"."""
    import tempfile

    import torch
    import yaml

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.io.dataset import DepthDataset, collate
    from cognitive_aim_tpu_torch.models.config import resolve_model_config

    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        raw = yaml.safe_load(f)
    arch = resolve_model_config(raw, lookup="nested")
    B, accum = int(raw["training"]["batch_size"]), int(raw["training"]["accumulation_steps"])
    wrappers = _wrappers()
    t0 = time.perf_counter()
    log(f"(g) training: {TRAIN_CONFIG}, ViT-B/14 {arch.image_size}x{arch.image_size}, "
        f"LoRA rank {arch.lora_rank} on {','.join(arch.lora_targets)}, "
        f"{arch.num_iterations} focal iterations, batch {B}, accumulation {accum}, "
        f"default policy, pallas_packed")
    kern, batch, grad = _grad_check(raw, arch, wrappers, B)

    raised = []
    calls, x = _gradless_calls()
    for name, call in calls.items():
        try:
            call(x.clone().requires_grad_(True))
        except RuntimeError as e:
            if "no backward" in str(e):
                raised.append(name)
                continue
            raise
        raise AssertionError(f"{name} ran under grad: its output would be detached")
    log(f"  every kernel without a backward raised under grad: {', '.join(raised)}")

    numbers = _step_times(kern, raw, batch, B)
    del kern, batch
    torch.cuda.empty_cache()
    for key in ("remat_on", "remat_off"):
        r = numbers[key]
        log(f"  micro-step ({key}): {r['micro_step_ms']:.1f} ms, {r['images_per_s']:.0f} "
            f"images/s, peak {r['max_memory_allocated_gib']:.2f} GiB ({smi})")

    # train_torch.py on a synthetic dataset: 512 train, 128 val, 256x256 PNGs
    import train_torch
    from cognitive_aim_tpu_torch.train import trainer as T

    work = os.path.join(ROOT, "build", "smoke_training")
    os.makedirs(work, exist_ok=True)
    root = tempfile.mkdtemp(dir=work)
    try:
        _write_dataset(os.path.join(root, "data"), 512, 128, 256, seed=21)
        snaps, initial = [], []
        step = T.Trainer.train_step

        def recording(self, *a, **kw):  # after each micro-step: the update count, fc0
            if not initial:
                initial.append(self.model.fusion.fc0.weight.detach().clone())
            logs = step(self, *a, **kw)
            p = self.model.fusion.fc0.weight
            snaps.append((self._groups["train"].updates, p.detach().clone()))
            return logs

        T.Trainer.train_step = recording
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        out_dir = os.path.join(root, "out")
        t_run = time.perf_counter()
        try:
            tr = train_torch.main(["--config", os.path.join(ROOT, TRAIN_CONFIG),
                                   "--data_dir", os.path.join(root, "data"),
                                   "--output_dir", out_dir, "--epochs", "2"])
        finally:
            T.Trainer.train_step = step
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = {k: w.launches for k, w in wrappers.items()}
        micro = len(snaps)
        n_layers, n_iters = tr.model.vit_cfg.num_layers, arch.num_iterations
        # each micro-step kind and each eval batch shape is one graph: the
        # wrappers count its eager first run and its capture, no replay
        kinds, evals = _graph_kinds(tr)
        val_forwards = 2 * -(-128 // B)
        want = {k: 0 for k in wrappers}
        want.update(K1=2 * (kinds * 2 * n_layers + evals * n_layers),
                    K6=2 * (kinds + evals) * n_iters)
        replays = sum(e.replays for e in tr.graphs.graphs.values())
        if (kinds, evals, replays) != (2, 1, micro - 2 + val_forwards):
            raise AssertionError(f"train_torch.main's graphs: {kinds} step kinds, {evals} "
                                 f"eval shapes, {replays} replays")
        epoch_losses = [h["loss"] for h in tr.history]
        val_losses = [h["val_loss"] for h in tr.history]
        updates = [c for c, _ in snaps]
        log(f"  train_torch.main: {micro} micro-steps, optimizer updates {updates}, epoch "
            f"losses {[round(h['loss'], 5) for h in tr.history]}, val "
            f"{[round(h['val_loss'], 5) for h in tr.history]}, {run_s:.1f} s")
        log(f"  launches counted in the run (the first run and the capture of {kinds} "
            f"micro-step graphs and {evals} eval graph; {replays} replays, which no wrapper "
            f"counts): K1 {launches['K1']} (want {want['K1']}), K6 {launches['K6']} (want "
            f"{want['K6']}), every other kernel 0")
        if micro != 2 * 512 // B or updates[-1] != micro // accum:
            raise AssertionError(f"{micro} micro-steps, {updates[-1]} updates")
        if launches != want:
            raise AssertionError(f"training launches {launches} != {want}")
        if not all(np.isfinite(l) for l in epoch_losses + val_losses):
            raise AssertionError(f"non-finite losses {epoch_losses} {val_losses}")
        # not before the first update, and at each update
        if bool((snaps[0][1] != initial[0]).any()):
            raise AssertionError("the parameters moved before the first optimizer update")
        moved = [bool((a != b).any()) for (_, a), (_, b) in zip(snaps, snaps[1:])]
        # fusion.fc0 moves at the updates (micro-steps accum, 2 accum) only
        want_moved = [(i + 2) % accum == 0 for i in range(micro - 1)]
        if moved != want_moved:
            raise AssertionError(f"parameter moves {moved} != {want_moved}")
        del snaps, initial
        files = ["checkpoint.npz", "model_best.npz", "checkpoint_epoch_0.npz",
                 "checkpoint_epoch_1.npz", "training_summary.md"]
        missing = [f for f in files if not os.path.exists(os.path.join(out_dir, f))]
        if missing:
            raise AssertionError(f"train_torch.py wrote no {missing}")

        # the best checkpoint served by the port's engine against the trainer's
        # own eval forward (noise 0 on both) on a val batch
        tr.load_checkpoint(os.path.join(out_dir, "model_best.npz"))
        tr.cfg.eval_noise_mode = "zeros"
        val = DepthDataset(os.path.join(root, "data"), "val", arch.image_size, True, False)
        vb = tr.device_batch(collate([val[i] for i in range(8)]))
        want_out = tr.eval_forward(vb["images"], vb["exif"])
        engine = CognitiveAimInference(os.path.join(ROOT, TRAIN_CONFIG),
                                       os.path.join(out_dir, "model_best.npz"),
                                       lookup="nested", policy="default",
                                       attn_impl="pallas_packed", noise_mode="zeros",
                                       save_images=False)
        got = engine._forward(vb["images"], vb["exif"])
        serve_err = max(max_err(got.depth, want_out.depth),
                        max_err(got.confidence, want_out.confidence))
        log(f"  model_best.npz served by CognitiveAimInference against the trainer's eval "
            f"forward on 8 val images: max abs {serve_err:.2e} (tol {TOL_TRAIN_SERVE:.0e})")
        if serve_err > TOL_TRAIN_SERVE:
            raise AssertionError("the engine's forward of the trained checkpoint disagrees "
                                 "with the trainer's")
        del engine, tr
    finally:
        shutil.rmtree(work, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (g) imported JAX or the JAX package: {foreign}")
    torch.cuda.empty_cache()
    log(f"phase (g) took {time.perf_counter() - t0:.1f} s")
    return {"config": TRAIN_CONFIG, "card": smi, "batch": B, "accumulation": accum,
            "gradient_check": grad, "gradless_wrappers_raised": raised,
            "run": {"micro_steps": micro, "optimizer_updates": micro // accum,
                    "epoch_losses": epoch_losses, "val_losses": val_losses,
                    "seconds": run_s, "launches": {"K1": launches["K1"],
                                                   "K6": launches["K6"]},
                    "graph_kinds": kinds, "eval_graphs": evals, "replays": replays,
                    "serve_max_abs_err": serve_err},
            **numbers}, launches


# ------------------------------------------------------- certification (h) ----
# the certification toolchain (cognitive_aim_tpu_torch/certify/) on the card, at
# ViT-B width with 6 focal iterations, as its recipe trains. Pretrain steps at
# 224x224, batch 32: sized so the pretrain stays near 90 s on the card
CERT_STEPS = 600
CERT_SPECS = ("2:0.25", "2:0.35", "2:0.25@p")
CERT_PLAIN_SPEC = "2:0.35"  # measured through the kernels and the plain versions
# kernels against plain versions on the same trained weights (section 2 of
# PERF.md): relative depth 2e-2 for the int8 filtered variant, 1e-4 for the
# strict f32 reference; kept sets overlap by MIN_KEPT_OVERLAP
TOL_CERT_DEPTH = 2e-2
TOL_CERT_F32 = 1e-4
CERT_DIR = os.path.join(ROOT, "build", "smoke_certify")  # listed in .gitignore


def _f32_launches(wrappers, counts):
    """Patch CognitiveAimModel.forward so that the launches of forwards under
    a float32 policy (K1's and K6's f32 programs) add to ``counts``; returns
    the function that undoes the patch."""
    import torch

    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel

    orig = CognitiveAimModel.forward

    def counted(self, *a, **kw):
        if self.policy.backbone_compute_dtype != torch.float32:
            return orig(self, *a, **kw)
        before = {k: w.launches for k, w in wrappers.items()}
        out = orig(self, *a, **kw)
        for k, w in wrappers.items():
            counts[k] += w.launches - before[k]
        return out

    CognitiveAimModel.forward = counted
    return lambda: setattr(CognitiveAimModel, "forward", orig)


def phase_certification(smi):
    """(h) certification on the card: procedural scenes, the guided pretrain,
    policy_delta, delta_sweep's measure, attention_stats and the round trip of
    the written checkpoint, each through the functions its CLI calls."""
    import tempfile

    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.certify import attention_stats as AS
    from cognitive_aim_tpu_torch.certify import common as CC
    from cognitive_aim_tpu_torch.certify import delta_sweep as DS
    from cognitive_aim_tpu_torch.certify import policy_delta as PD
    from cognitive_aim_tpu_torch.certify import pretrain as PT
    from cognitive_aim_tpu_torch.certify import procedural as P
    from cognitive_aim_tpu_torch.io.preprocess import normalize_np
    from cognitive_aim_tpu_torch.models import guidance as G

    wrappers = _wrappers()
    total = {k: 0 for k in wrappers}
    f32 = {k: 0 for k in wrappers}

    def take():
        """The launches since the last call, added to the phase's total."""
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        for k, w in wrappers.items():
            total[k] += got[k]
            w.launches = 0
        return got

    t0 = time.perf_counter()
    S, B, steps, n_train, n_eval, serve = 224, 32, CERT_STEPS, 512, 32, 518
    log(f"(h) certification: ViT-B/14 (12 layers, D 768, 12 heads), 6 focal iterations, "
        f"procg pretrain at {S}x{S}, batch {B}, {steps} steps")
    shutil.rmtree(CERT_DIR, ignore_errors=True)
    ckdir, datadir = os.path.join(CERT_DIR, "ckpts"), os.path.join(CERT_DIR, "data")
    out = {"card": smi}
    undo = _f32_launches(wrappers, f32)
    try:
        take()
        # 1. scenes: the pretrain's training set (into its cache) and held-out sets
        args = PT.parse_args(["--guided", "--seed", "0", "--steps", str(steps),
                              "--n-images", str(n_train), "--batch", str(B),
                              "--image-size", str(S), "--n-eval", str(n_eval),
                              "--eval-every", str(steps), "--ckpt-dir", ckdir,
                              "--data-cache", datadir])
        secs = {}
        ts = time.perf_counter()
        P.cached(PT.cache_names(args)[0], P.gen_procedural_u8, n_train, S, 0)
        secs[f"train_{n_train}_at_{S}"] = time.perf_counter() - ts
        ts = time.perf_counter()
        e224, gt224 = P.gen_procedural(n_eval, S, DS.EVAL_SEED)
        secs[f"eval_{n_eval}_at_{S}"] = time.perf_counter() - ts
        ts = time.perf_counter()
        e518, _ = P.gen_procedural(16, serve, DS.EVAL_SEED)
        secs[f"eval_16_at_{serve}"] = time.perf_counter() - ts
        log("  scenes (numpy, one core): " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
        out["scene_seconds"] = secs

        # 2. the guided pretrain
        ts = time.perf_counter()
        summ = PT.main(["--guided", "--seed", "0", "--steps", str(steps),
                        "--n-images", str(n_train), "--batch", str(B), "--image-size", str(S),
                        "--n-eval", str(n_eval), "--eval-every", str(steps),
                        "--ckpt-dir", ckdir, "--data-cache", datadir])
        pre_s = time.perf_counter() - ts
        got = take()
        model, ckpt, losses, evals = summ["model"], summ["checkpoint"], summ["losses"], summ["evals"]
        n_layers, n_iters = model.vit_cfg.num_layers, model.arch.num_iterations
        eval_forwards = len(evals) * -(-n_eval // 16) * (1 + len(G.INSTRUCTIONS))
        # the steps replay graphs: the wrappers count each kind's eager first
        # run and its capture; the evals run eagerly
        kinds, _ = _graph_kinds(summ["trainer"])
        want = {k: 0 for k in wrappers}
        want.update(K1=kinds * 2 * 2 * n_layers + eval_forwards * n_layers,
                    K6=(kinds * 2 + eval_forwards) * n_iters)
        first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
        step_ms = summ["train_s"] / steps * 1e3
        log(f"  pretrain: {pre_s:.1f} s ({summ['train_s']:.1f} s of {steps} steps, "
            f"{step_ms:.1f} ms a step, {B / step_ms * 1e3:.0f} images/s; {smi}); loss mean "
            f"of the first 20 {first:.4f}, of the last 20 {last:.4f}")
        log(f"  held-out AbsRel (32 scenes, seed {PT.EVAL_DATA_SEED}): seeded model "
            f"{evals[0]['absrel'] * 100:.2f}% unguided, {evals[0]['absrel_worst_instruction'] * 100:.2f}"
            f"% worst instruction; trained {evals[-1]['absrel'] * 100:.2f}%, "
            f"{evals[-1]['absrel_worst_instruction'] * 100:.2f}%")
        log(f"  launches counted in the pretrain ({kinds} micro-step graphs, each counted at "
            f"its first run and its capture; {steps - kinds} replays): K1 {got['K1']} (want "
            f"{want['K1']}), K6 {got['K6']} (want {want['K6']}), every other kernel 0")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite pretrain losses: {losses}")
        if not last < first:
            raise AssertionError(f"the pretrain did not learn: {first} -> {last}")
        for key in ("absrel", "absrel_worst_instruction"):
            if not evals[-1][key] < evals[0][key]:
                raise AssertionError(f"held-out {key} {evals[0][key]} -> {evals[-1][key]}")
        if got != want:
            raise AssertionError(f"pretrain launches {got} != {want}")
        out["pretrain"] = {"seconds": pre_s, "train_s": summ["train_s"], "step_ms": step_ms,
                           "loss_first20": first, "loss_last20": last, "evals": evals,
                           "launches": {"K1": got["K1"], "K6": got["K6"]}}

        # 3. policy_delta at the serving shape
        ts = time.perf_counter()
        pd = PD.main(["--checkpoint", ckpt, "--n", "16", "--image-size", str(serve),
                      "--batch", "8", "--token-filter", "2:0.35"])
        got = take()
        for name, t in pd.items():
            log(f"  policy_delta {name} vs f32 at {serve}x{serve} (16 scenes): " + ", ".join(
                f"{g} {t['absrel'][g]:.2e}/{t['dconf'][g]:.1e}" for g in G.INSTRUCTIONS)
                + f"; worst {t['worst']:.3e} (AbsRel/|dconf|)")
        if not pd["int8"]["worst"] < PD.BUDGET:
            raise AssertionError(f"int8 alone exceeds the 1% budget: {pd['int8']['worst']}")
        out["policy_delta"] = {"seconds": time.perf_counter() - ts, "tables": pd,
                               "launches": got}

        # 4. delta_sweep's measure through its CLI, then one spec through the
        # kernels and through the plain versions on the same weights
        ts = time.perf_counter()
        ds_json = os.path.join(CERT_DIR, "delta_sweep.json")
        ds = DS.main(["--measure-only", "--seeds", "0", "--laws", "procg",
                      "--steps", str(steps), "--image-size", str(S),
                      "--n-eval", str(n_eval), "--ckpt-dir", ckdir,
                      "--filters", ";".join(CERT_SPECS), "--out", ds_json])
        run = ds["runs"][0]
        for spec in CERT_SPECS:
            gap = max(abs(run["absrel_gt"][spec][g] - run["absrel_gt"]["f32"][g])
                      for g in G.INSTRUCTIONS)
            log(f"  delta_sweep {spec}: prediction parity worst {max(run['table'][spec].values()):.3e}"
                f", gt-gap worst {gap:.3e}; gt AbsRel f32 "
                f"{max(run['absrel_gt']['f32'].values()):.3e} worst instruction")
        flat = CC.load_flat(ckpt)[0]
        batches = DS.eval_batches(normalize_np(e224), 16, "cuda")
        routes = {}
        for impl in ("pallas_packed", "plain"):
            routes[impl] = DS.measure(flat, flat, [CERT_PLAIN_SPEC], batches, gt=gt224,
                                      eval_size=S, attn_impl=impl, device="cuda")[2]
        got = take()

        def rel(a, b):
            return max(float(np.max(np.abs(a[g] - b[g]) / np.abs(b[g]))) for g in b)

        spec_err = rel(routes["pallas_packed"][CERT_PLAIN_SPEC], routes["plain"][CERT_PLAIN_SPEC])
        f32_err = rel(routes["pallas_packed"]["f32"], routes["plain"]["f32"])
        overlaps = []
        for impl in ("pallas_packed", "plain"):
            routes[impl + "_kept"] = []
            m = DS.loaded(DS.variant_model(CERT_PLAIN_SPEC, S, attn_impl=impl, device="cuda"),
                          flat)
            gidx = torch.arange(16, device="cuda") % len(G.INSTRUCTIONS)
            with torch.no_grad():
                for xb in batches:
                    routes[impl + "_kept"].append(_kept_sets(m, xb, gidx)[1])
            del m
        for a, b in zip(routes["pallas_packed_kept"], routes["plain_kept"]):
            for ra, rb in zip(a.tolist(), b.tolist()):
                overlaps.append(len(set(ra) & set(rb)) / len(rb))
        take()
        log(f"  {CERT_PLAIN_SPEC} int8 kernels vs plain versions on the trained weights: depth "
            f"rel {spec_err:.2e} (tol {TOL_CERT_DEPTH:.0e}), kept sets overlap >= "
            f"{min(overlaps):.4f} (tol {MIN_KEPT_OVERLAP}); the strict f32 reference "
            f"{f32_err:.2e} (tol {TOL_CERT_F32:.0e})")
        if spec_err > TOL_CERT_DEPTH or f32_err > TOL_CERT_F32 or min(overlaps) < MIN_KEPT_OVERLAP:
            raise AssertionError("delta_sweep: kernels and plain versions disagree")
        out["delta_sweep"] = {"seconds": time.perf_counter() - ts, "run": run,
                              "kernels_vs_plain": {"spec": CERT_PLAIN_SPEC,
                                                   "depth_rel": spec_err, "f32_depth_rel": f32_err,
                                                   "kept_overlap_min": min(overlaps)}}

        # 5. attention statistics: random init against the trained weights
        ts = time.perf_counter()
        before = {k: w.launches for k, w in wrappers.items()}
        st = AS.main(["--checkpoint", ckpt, "--image-size", str(S), "--n", "16",
                      "--out", os.path.join(CERT_DIR, "attn_stats.json")])
        for k, w in wrappers.items():  # every block of these statistics runs in f32
            f32[k] += w.launches - before[k]
        take()
        tables = {name: np.asarray(rows) for name, rows in st["per_layer"].items()}
        if not all(np.isfinite(t).all() and (t[:, 0] > 0).all() and (t[:, 0] <= 1 + 1e-6).all()
                   for t in tables.values()):
            raise AssertionError(f"attention statistics out of range: {st['per_layer']}")
        name = os.path.basename(ckpt)
        log(f"  attention_stats (16 scenes at {S}): layer-mean entropy/lnP random "
            f"{tables['random_init'][:, 0].mean():.3f}, trained {tables[name][:, 0].mean():.3f};"
            f" top-1% mass random {tables['random_init'][:, 1].mean():.3f}, trained "
            f"{tables[name][:, 1].mean():.3f} (layer 2: {tables['random_init'][2, 1]:.3f} -> "
            f"{tables[name][2, 1]:.3f})")
        out["attention_stats"] = {"seconds": time.perf_counter() - ts, **st}

        # 6. the written npz against the in-memory model: through the engine at
        # 518 (default policy) and through delta_sweep's f32 loading at 224
        ts = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=CERT_DIR) as tmp:
            cfg_path = os.path.join(tmp, "engine.json")
            with open(cfg_path, "w") as f:
                json.dump(PD.engine_config(serve), f)
            engine = CognitiveAimInference(cfg_path, ckpt, device="cuda", policy="default",
                                           attn_impl="pallas_packed", noise_mode="zeros",
                                           save_images=False)
        x518 = torch.from_numpy(normalize_np(e518)).cuda()
        exif = CC.exif_batch(16, "cuda")
        g16 = torch.arange(16, device="cuda") % len(G.INSTRUCTIONS)
        engine_err = 0.0
        for gv in (None, g16):
            want_d = CC.depths(model, x518, gv)
            got_d = engine._forward(x518, exif, gv).depth[:, 0]
            engine_err = max(engine_err, max_err(got_d, want_d))
        del engine
        mem = DS.f32_model(S, device="cuda")
        mem.load_state_dict(model.state_dict())  # the trained float32 masters
        mem_d = DS.model_depths(mem.prepare_params(), batches, DS.instruction_names())
        sweep_err = max(float(np.max(np.abs(mem_d[g] - routes["pallas_packed"]["f32"][g])))
                        for g in mem_d)
        del mem
        take()
        log(f"  round trip of {os.path.basename(ckpt)}: CognitiveAimInference at {serve} against the "
            f"in-memory model, max abs {engine_err:.2e}; delta_sweep's f32 model from the npz "
            f"against the in-memory weights, max abs {sweep_err:.2e} (tol {TOL_TRAIN_SERVE:.0e})")
        if engine_err > TOL_TRAIN_SERVE or sweep_err > TOL_TRAIN_SERVE:
            raise AssertionError("the written checkpoint does not reproduce the trained model")
        out["round_trip"] = {"engine_max_abs": engine_err, "delta_sweep_max_abs": sweep_err,
                             "seconds": time.perf_counter() - ts}
        del model, summ
    finally:
        undo()
        shutil.rmtree(CERT_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu", "scripts")
               or m in ("procedural_scenes", "policy_delta", "train_synth_ckpt",
                        "pretrain_procedural", "attention_stats", "delta_sweep",
                        "certify_filter")]
    if foreign:
        raise AssertionError(f"phase (h) imported JAX, the JAX package or scripts/: {foreign}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in total.items() if v}
    out["launches_f32"] = {k: v for k, v in f32.items() if v}
    log(f"phase (h) took {out['seconds']:.1f} s; launches {out['launches']} (of which under a "
        f"float32 policy {out['launches_f32']})")
    return out, total, f32


# ----------------------------------------------------------- parallel (i) ----
# the parallel layer (core/mesh.py, parallel/, the trainer's and the engine's
# meshes) on the card, at world 1: one card, and NCCL takes one rank a device
PARALLEL_DIR = os.path.join(ROOT, "build", "smoke_parallel")  # listed in .gitignore
TP2_FILTER = "2:0.35"  # the token filter of the TP 2 pair's second step
PARALLEL_IMAGES = 32
PARALLEL_BATCH = 8  # the engine's chunk
PIPE_MICRO = 4
TOL_PIPELINE = 2e-2  # relative depth and confidence, the bf16 paths' bound
TOL_MESH_STEP = 1e-6  # relative loss and parameters, float32, mesh against none
MESH_STEPS, MESH_BATCH = 3, 32


def _launch_counts(wrappers):
    import torch

    torch.cuda.synchronize()
    return {k: w.launches for k, w in wrappers.items()}


def _zero_launches(wrappers):
    import torch

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0


def _replay_launches(tag, eager, replay, wrappers, replays=1):
    """The launches of ``replays`` CUDA graph replays, read from the device,
    with replay()'s result. A replay runs no wrapper, so no Python count
    sees it: eager() and replay() run in one torch.profiler window
    (utils.profiling.traced_kernels). The replay must run no wrapper and the
    caim kernels the eager run's wrappers launched, in the same order,
    ``replays`` times over: each wrapper then launched in the replays what
    it launched in the eager run (its own count of that run) times
    ``replays``. Returns (replay()'s result, {kernel id: launches in the
    replays}, the caim kernels they ran)."""
    import difflib

    from cognitive_aim_tpu_torch.utils.profiling import traced_kernels

    _zero_launches(wrappers)
    eager()  # one run counted (a trace may run it again)
    live = _launch_counts(wrappers)
    ran = {}

    def counted_replay():
        _zero_launches(wrappers)
        result = replay()
        ran.update(_launch_counts(wrappers))
        return result

    (_, eager_names), (got, names) = traced_kernels(eager, counted_replay)
    if not eager_names or any(ran.values()):
        raise AssertionError(f"{tag}: the eager run's trace holds {len(eager_names)} caim "
                             f"kernels; the replay ran wrappers {ran}: not graph replays")
    want = eager_names * replays
    if names != want:
        short, wshort = ([n.split("(")[0].replace("void caim::", "") for n in ns]
                         for ns in (names, want))
        ops = difflib.SequenceMatcher(None, short, wshort, autojunk=False)
        raise AssertionError(
            f"{tag}: the replay ran {len(names)} caim kernels, the eager run {len(want)} "
            f"({len(eager_names)} a run x {replays}); where they differ (replay / eager "
            f"positions): " + "; ".join(
                f"{op} {short[i1:i2][:3]} / {wshort[j1:j2][:3]} at {i1}-{i2} / {j1}-{j2}"
                for op, i1, i2, j1, j2 in ops.get_opcodes() if op != "equal"))
    return got, {k: n * replays for k, n in live.items()}, len(names)


def _vit_l_pipeline(wrappers, mesh=None):
    """ViT-L 518 under the default policy, B 8, seeded weights: the
    sequential forward (``mesh`` None) or the pipelined one over ``mesh``.
    Returns (outputs, launches, ms)."""
    import torch

    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig

    S, B = 518, 8
    model = CognitiveAimModel(ModelArchConfig(backbone_size="large", num_iterations=2,
                                              image_size=S), DEFAULT_POLICY, "pallas_packed")
    g = torch.Generator(device="cuda").manual_seed(31)
    model.init(g).prepare_params()
    x = torch.randn(B, S, S, 3, generator=g, device="cuda")
    exif = {"camera_idx": torch.zeros(B, dtype=torch.long, device="cuda"),
            "focal_length": torch.full((B,), 50.0, device="cuda"),
            "aperture": torch.full((B,), 2.8, device="cuda"),
            "iso": torch.full((B,), 100.0, device="cuda")}
    gidx = torch.arange(B, device="cuda") % 9
    kw = {} if mesh is None else dict(pipeline_mesh=mesh, pipeline_n_micro=PIPE_MICRO)
    with torch.no_grad():
        fwd = lambda: model(x, exif, guidance=gidx, **kw)  # noqa: E731
        fwd()  # first call: lazy kernel builds are done by phase (b)
        _zero_launches(wrappers)
        out = fwd()
        launches = _launch_counts(wrappers)
        ms = cuda_ms(fwd, iters=5, warmup=1)
    del model
    return {"depth": out.depth, "confidence": out.confidence}, launches, ms


def _mesh_training(raw, arch, mesh, tp, steps=MESH_STEPS):
    """``steps`` steps of experiment_B.yaml's trainer at batch MESH_BATCH in
    float32 (K1 f32, K6 f32) from seeded weights and one generator: the loss
    of each step, the whole parameters after, and the steps' CUDA-event
    times."""
    import torch

    from cognitive_aim_tpu_torch.core.precision import STRICT_F32
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.parallel.sharding import unsharded
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    g = torch.Generator(device="cuda").manual_seed(41)
    model = CognitiveAimModel(arch, STRICT_F32, "pallas_packed").init(g)
    with torch.no_grad():  # lora_B 0 (its init) would leave lora_A's gradient 0
        for blk in model.backbone.layers:
            blk.lora_B.normal_(0.0, 0.02, generator=g)
    cfg = TrainConfig.from_raw(raw, steps_per_epoch=4)
    cfg.batch_size, cfg.accumulation_steps, cfg.tensor_parallel = MESH_BATCH, 1, tp
    tr = Trainer(model, cfg, output_dir=os.path.join(PARALLEL_DIR, "train"), mesh=mesh)
    batch = _train_batch(MESH_BATCH, arch.image_size, torch.Generator(device="cuda")
                         .manual_seed(43))
    gen = torch.Generator(device="cuda").manual_seed(47)
    losses, times = [], []
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logs = tr.train_step(batch, gen, fetch_logs=False)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(logs["loss"]))
    with unsharded(model):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del tr, model
    return losses, params, times


def _filtered_arch(arch, spec=TP2_FILTER):
    """``arch`` with the token filter ``spec`` on in training too."""
    import dataclasses

    from cognitive_aim_tpu_torch.models.config import parse_token_filter

    return dataclasses.replace(arch, **parse_token_filter(spec), token_filter_train=True)


def _tp2_rank(rank, rendezvous, result):
    """One of the two ranks of a gloo world that share the card: one step of
    experiment_B.yaml's trainer at tensor parallelism 2 (each rank 6 of the
    12 heads, half of fc1's columns), then one under the token filter
    ``TP2_FILTER`` (each rank the CLS rows of its heads, summed over
    ``model``); rank 0 saves the losses, the whole parameters and its
    launches to ``result``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    import yaml

    from cognitive_aim_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.nn import dinov2

    initialize_distributed(device="cuda", backend="gloo", init_method=f"file://{rendezvous}",
                           rank=rank, world_size=2)
    heads, attend = set(), dinov2.attend

    def spy(attn_impl, q, k, v, k_bias, scale, num_heads):  # the heads K1 runs on
        heads.add(num_heads)
        return attend(attn_impl, q, k, v, k_bias, scale, num_heads)

    kept, keep_indices = [], dinov2._keep_indices

    def keep_spy(importance, keep_weights, k_keep, ctx_frac=0.0):
        kept.append(k_keep)
        return keep_indices(importance, keep_weights, k_keep, ctx_frac)

    dinov2.attend, dinov2._keep_indices = spy, keep_spy
    try:
        with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
            raw = yaml.safe_load(f)
        arch = resolve_model_config(raw, lookup="nested")
        wrappers = _wrappers()
        _zero_launches(wrappers)
        losses, params, times = _mesh_training(
            raw, arch, make_mesh(model_parallel=2, device="cuda"), True, steps=1)
        launches = _launch_counts(wrappers)
        f_losses, f_params, f_times = _mesh_training(
            raw, _filtered_arch(arch), make_mesh(model_parallel=2, device="cuda"), True,
            steps=1)
        if rank == 0:
            torch.save({"losses": losses, "times": times, "launches": launches,
                        "heads": sorted(heads),
                        "params": {n: p.cpu() for n, p in params.items()},
                        "filtered": {"losses": f_losses, "times": f_times, "kept": kept,
                                     "params": {n: p.cpu() for n, p in f_params.items()}}},
                       result)
    finally:
        dinov2.attend, dinov2._keep_indices = attend, keep_indices
        dist.destroy_process_group()


def phase_parallel(smi, packages):
    """(i) the parallel layer on the card at world 1, NCCL: the engine's
    data-parallel path against mesh=None, the GPipe forward of ViT-L 518
    against the sequential one, and experiment_B's trainer on a mesh with
    tensor_parallel against the trainer without one. Every mesh=None run
    comes before the process group starts: with one, mesh=None builds a
    mesh whose collectives run."""
    import tempfile

    import torch
    import torch.distributed as dist
    import yaml

    from cognitive_aim_tpu_torch.api import CognitiveAimInference, load_config
    from cognitive_aim_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS
    from cognitive_aim_tpu_torch.parallel.pipeline import make_pipeline_mesh

    t0 = time.perf_counter()
    wrappers = _wrappers()
    log(f"(i) parallel, world 1 on {smi}: the engine's data-parallel path ({SERVE_CONFIG}, "
        f"int8, {PARALLEL_IMAGES} images), the GPipe forward of ViT-L 518 (B 8, "
        f"{PIPE_MICRO} microbatches), {TRAIN_CONFIG}'s trainer on a mesh "
        f"({MESH_STEPS} steps, batch {MESH_BATCH}, float32)")
    if packages["yaml"] is None or packages["PIL"] is None:
        raise RuntimeError("phase (i) needs PyYAML for the configs and PIL for the images")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR, exist_ok=True)
    os.makedirs(PARALLEL_DIR)
    out = {"card": smi}
    launches = {}
    try:
        # ---- mesh=None: the engine, the sequential ViT-L forward, the trainer
        cfgs = _serving_configs(load_config(os.path.join(ROOT, SERVE_CONFIG)))
        _, paths = _image_files(np.random.RandomState(17), PARALLEL_IMAGES)
        instructions = [INSTRUCTIONS[i % len(INSTRUCTIONS)] for i in range(PARALLEL_IMAGES)]
        kw = dict(policy="int8", attn_impl="pallas_packed", noise_mode="zeros",
                  save_images=False)
        engines, want, none_s = {}, {}, {}
        for tag in ("exact", "fast"):
            engines[tag] = CognitiveAimInference(cfgs[tag], None, seed=0, **kw)
            engines[tag].predict_paths_batched(paths[:PARALLEL_BATCH], batch_size=PARALLEL_BATCH,
                                               instructions=instructions[:PARALLEL_BATCH])
            t = time.perf_counter()
            want[tag] = engines[tag].predict_paths_batched(
                paths, instructions=instructions, batch_size=PARALLEL_BATCH)
            none_s[tag] = time.perf_counter() - t
        seq, seq_launches, seq_ms = _vit_l_pipeline(wrappers)
        log(f"  ViT-L 518 sequential forward (the first ViT-L forward on the card): "
            f"{seq_ms:.2f} ms a forward of 8, launches K1 {seq_launches['K1']} "
            f"(want 24), K6 {seq_launches['K6']} (want 2) ({smi})")
        if {k: v for k, v in seq_launches.items() if v} != {"K1": 24, "K6": 2}:
            raise AssertionError(f"ViT-L forward launches {seq_launches}")
        torch.cuda.empty_cache()
        with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
            raw = yaml.safe_load(f)
        arch = resolve_model_config(raw, lookup="nested")
        none_loss, none_params, none_times = _mesh_training(raw, arch, None, False)
        tp1_loss, tp1_params, _ = _mesh_training(raw, arch, None, False, steps=1)
        tp1f_loss, tp1f_params, _ = _mesh_training(raw, _filtered_arch(arch), None, False,
                                                   steps=1)
        torch.cuda.empty_cache()

        # ---- the process group: NCCL, world 1
        initialize_distributed(device="cuda", init_method=f"file://{PARALLEL_DIR}/rendezvous",
                               rank=0, world_size=1)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the process group runs {dist.get_backend()}, not NCCL")
            mesh = make_mesh()
            log(f"  process group: {dist.get_backend()}, world {dist.get_world_size()}; "
                f"make_mesh() {mesh.shape}")

            # 1. the engine's data-parallel path
            per_forward = dict(_CHAINED, K1=12)
            dp = {}
            for tag, engine in engines.items():
                # warm: NCCL builds its communicator at the first collective
                engine.predict_paths_batched(paths[:PARALLEL_BATCH], batch_size=PARALLEL_BATCH,
                                             instructions=instructions[:PARALLEL_BATCH],
                                             mesh=mesh)
                t = time.perf_counter()
                got = engine.predict_paths_batched(paths, instructions=instructions,
                                                   batch_size=PARALLEL_BATCH, mesh=mesh)
                mesh_s = time.perf_counter() - t
                forwards = -(-PARALLEL_IMAGES // PARALLEL_BATCH)
                # the launches of the mesh path's replays, read from their trace
                # against mesh=None's captured forward run eagerly
                (entry,) = [e for (k, _), e in engine.compiled.graphs.items() if k.shard is None]
                _, counts, n_kernels = _replay_launches(
                    f"data-parallel engine ({tag})",
                    lambda: engine._compiled_fn(entry.inputs, None),
                    lambda: engine.predict_paths_batched(
                        paths, instructions=instructions, batch_size=PARALLEL_BATCH, mesh=mesh),
                    wrappers, replays=forwards)
                expect = {k: per_forward.get(k, 0) * forwards for k in wrappers}
                same = got == want[tag]
                log(f"  data-parallel engine ({tag}): {len(got)} results "
                    f"{'bit-equal to' if same else 'DIFFER from'} mesh=None's; "
                    f"{mesh_s * 1e3:.1f} ms (mesh=None {none_s[tag] * 1e3:.1f} ms) for "
                    f"{PARALLEL_IMAGES} images with decode ({smi}); launches "
                    + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
                    + f" in {forwards} replays (read from their trace, {n_kernels} caim "
                    f"kernels)")
                if not same:
                    raise AssertionError(f"{tag}: the mesh path's results differ from "
                                         f"mesh=None's")
                if counts != expect:
                    raise AssertionError(f"{tag}: launches {counts} != {expect}")
                dp[tag] = {"bit_equal": same, "ms": mesh_s * 1e3,
                           "mesh_none_ms": none_s[tag] * 1e3, "forwards": forwards}
                launches[f"dp_{tag}"] = counts
            out["dp_engine"] = dp
            del engines
            torch.cuda.empty_cache()

            # 2. the GPipe forward of ViT-L 518
            pmesh = make_pipeline_mesh(1)
            got, pp_launches, pp_ms = _vit_l_pipeline(wrappers, pmesh)
            rd = _rel(got["depth"], seq["depth"])
            rc = _rel(got["confidence"], seq["confidence"])
            want_k1 = 24 * PIPE_MICRO // pmesh.shape["pipe"]
            log(f"  ViT-L 518 pipelined over {pmesh.shape}, {PIPE_MICRO} microbatches: "
                f"depth rel {rd:.2e}, confidence rel {rc:.2e} (tol {TOL_PIPELINE:.0e}) of the "
                f"sequential forward; {pp_ms:.2f} ms (sequential {seq_ms:.2f}) ({smi}); "
                f"launches K1 {pp_launches['K1']} (want {want_k1}), K6 {pp_launches['K6']} "
                f"(want 2)")
            if rd > TOL_PIPELINE or rc > TOL_PIPELINE:
                raise AssertionError("the pipelined ViT-L forward disagrees with the "
                                     "sequential one")
            if {k: v for k, v in pp_launches.items() if v} != {"K1": want_k1, "K6": 2}:
                raise AssertionError(f"pipelined launches {pp_launches}")
            out["pipeline"] = {"mesh": pmesh.shape, "n_micro": PIPE_MICRO,
                               "depth_rel": rd, "confidence_rel": rc, "ms": pp_ms,
                               "sequential_ms": seq_ms}
            launches["pipeline"], launches["vit_l_sequential"] = pp_launches, seq_launches
            del seq, got
            torch.cuda.empty_cache()

            # 3. experiment_B's trainer on the mesh, tensor_parallel
            _zero_launches(wrappers)
            mesh_loss, mesh_params, mesh_times = _mesh_training(raw, arch, make_mesh(), True)
            launches["mesh_training"] = _launch_counts(wrappers)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_loss, none_loss))
            p_rel = max(float((mesh_params[n] - p).abs().max() / p.abs().max().clamp(min=1e-30))
                        for n, p in none_params.items())
            equal = sum(bool(torch.equal(mesh_params[n], p)) for n, p in none_params.items())
            ms_mesh, ms_none = float(np.median(mesh_times[1:])), float(np.median(none_times[1:]))
            log(f"  {TRAIN_CONFIG} on make_mesh() with tensor_parallel, {MESH_STEPS} steps at "
                f"batch {MESH_BATCH}, float32: losses {mesh_loss} against {none_loss} without "
                f"a mesh, rel {loss_rel:.2e}; parameters rel {p_rel:.2e} (tol "
                f"{TOL_MESH_STEP:.0e}), {equal} of {len(none_params)} tensors bit-equal; "
                f"step {ms_mesh:.2f} ms on the mesh, {ms_none:.2f} ms without "
                f"(collective path {ms_mesh - ms_none:+.2f} ms) ({smi})")
            if loss_rel > TOL_MESH_STEP or p_rel > TOL_MESH_STEP:
                raise AssertionError("the trainer on a world-1 mesh disagrees with the "
                                     "trainer without one")
            out["mesh_training"] = {
                "steps": MESH_STEPS, "batch": MESH_BATCH, "losses": mesh_loss,
                "losses_mesh_none": none_loss, "loss_rel": loss_rel, "params_rel": p_rel,
                "tensors_bit_equal": equal, "tensors": len(none_params),
                "step_ms": ms_mesh, "step_ms_mesh_none": ms_none,
                "step_ms_all": mesh_times, "step_ms_all_mesh_none": none_times}
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # 4. tensor parallelism 2 on the one card: two processes, gloo (NCCL takes
        # one rank a device), against the step at world 1 above
        import torch.multiprocessing as mp

        result = os.path.join(PARALLEL_DIR, "tp2.pt")
        t = time.perf_counter()
        mp.spawn(_tp2_rank, args=(os.path.join(PARALLEL_DIR, "rendezvous_tp2"), result),
                 nprocs=2, join=True)
        tp2_s = time.perf_counter() - t
        tp2 = torch.load(result)
        loss_rel = abs(tp2["losses"][0] - tp1_loss[0]) / abs(tp1_loss[0])
        excess = max(float(((tp2["params"][n] - p.cpu()).abs() - 2e-3 * p.cpu().abs()).max())
                     for n, p in tp1_params.items())
        log(f"  tensor parallelism 2 on the one card (2 processes, gloo): one step, loss "
            f"{tp2['losses'][0]:.6f} against {tp1_loss[0]:.6f} at world 1, rel {loss_rel:.2e} "
            f"(tol 1e-4); parameters within atol {max(excess, 0.0):.2e} beyond rtol 2e-3 "
            f"(tol 1e-4); a rank's K1 ran on {tp2['heads']} of 12 heads; a rank's launches: K1 "
            f"{tp2['launches']['K1']}, K6 {tp2['launches']['K6']}; the step "
            f"{tp2['times'][0]:.1f} ms on rank 0, {tp2_s:.1f} s with the processes' start "
            f"({smi})")
        if loss_rel > 1e-4 or excess > 1e-4 or tp2["heads"] != [6]:
            raise AssertionError("the TP 2 step on the card disagrees with world 1's")
        tf = tp2["filtered"]
        f_rel = abs(tf["losses"][0] - tp1f_loss[0]) / abs(tp1f_loss[0])
        f_excess = max(float(((tf["params"][n] - p.cpu()).abs() - 2e-3 * p.cpu().abs()).max())
                       for n, p in tp1f_params.items())
        log(f"  tensor parallelism 2 under the token filter {TP2_FILTER} (filtered in "
            f"training; each rank the CLS rows of its heads, summed over model): one step, "
            f"loss {tf['losses'][0]:.6f} against {tp1f_loss[0]:.6f} at world 1, rel "
            f"{f_rel:.2e} (tol 1e-4); parameters within atol {max(f_excess, 0.0):.2e} beyond "
            f"rtol 2e-3 (tol 1e-4); kept per stage {sorted(set(tf['kept']))} of "
            f"{(arch.image_size // 14) ** 2}; the step {tf['times'][0]:.1f} ms on rank 0 "
            f"({smi})")
        if f_rel > 1e-4 or f_excess > 1e-4 or not tf["kept"]:
            raise AssertionError("the filtered TP 2 step on the card disagrees with world 1's")
        out["tp2_on_one_card"] = {"backend": "gloo", "k1_heads": tp2["heads"],
                                  "loss": tp2["losses"][0],
                                  "loss_world1": tp1_loss[0], "loss_rel": loss_rel,
                                  "param_excess_over_rtol": excess,
                                  "step_ms": tp2["times"][0], "seconds": tp2_s,
                                  "filtered": {"spec": TP2_FILTER, "loss": tf["losses"][0],
                                               "loss_world1": tp1f_loss[0], "loss_rel": f_rel,
                                               "param_excess_over_rtol": f_excess,
                                               "step_ms": tf["times"][0]}}
        launches["tp2_rank0"] = tp2["launches"]
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (i) imported JAX or the JAX package: {foreign}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase (i) took {out['seconds']:.1f} s")
    return out, launches


EXPORT_DIR = os.path.join(ROOT, "build", "smoke_export")  # listed in .gitignore
# (point, config of phase (f), batch): scripts/export_model.py's B 16 exact, and
# the config's fast point 2:0.35 at B 8
EXPORT_POINTS = (("exact", "exact", 16), ("2:0.35", "fast", 8))
# caim op -> its nodes in the program and its launches in one forward of the
# loaded program, at both points (2:0.35 drops tokens after block 2: K1 still 12)
EXPORT_OPS = {"int8_qkv_proj_ln": "K2", "flash_attention_packed": "K1",
              "int8_out_residual": "K3", "int8_fc1_gelu_ln": "K4a",
              "int8_out_residual_prequant": "K4b", "int8_qkv_proj": "K5",
              "focal_attention_fused": "K6"}
EXPORT_LAUNCHES = {"K2": 12, "K1": 12, "K3": 12, "K4a": 12, "K4b": 12, "K5": 2, "K6": 2}


def _events_ms(fn, reps: int = 3):
    """CUDA-event times of ``reps`` calls of fn, one at a time."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_export(smi, packages):
    """(j) scripts/torch_export_model.py on the card: the engine's serving
    forward at ViT-B 518 int8 exported with torch.export (B 16 exact, B 8 at
    2:0.35), saved, loaded and rebuilt from its npz as a consumer does; the
    program's caim nodes, one forward of the loaded program against the live
    one (rtol 2e-5 / atol 1e-6) and the launches it made, which show that the
    artifact runs the kernels; export, load and forward times."""
    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference, load_config
    from cognitive_aim_tpu_torch.core.compiled import CompiledForward
    from cognitive_aim_tpu_torch.kernels._library import op_counts

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_export_model as EXP

    t0 = time.perf_counter()
    wrappers = _wrappers()
    log(f"(j) export on {smi}: {SERVE_CONFIG} (use_lora off), policy int8, pallas_packed, "
        f"torch {torch.__version__}: " + ", ".join(f"{p} B {b}" for p, _, b in EXPORT_POINTS))
    if packages["yaml"] is None:
        raise RuntimeError("phase (j) needs PyYAML for the config")
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    os.makedirs(SERVE_DIR, exist_ok=True)
    out, launches = {}, {}
    try:
        cfgs = _serving_configs(load_config(os.path.join(ROOT, SERVE_CONFIG)))
        for point, cfg, B in EXPORT_POINTS:
            engine = CognitiveAimInference(cfgs[cfg], None, seed=0, policy="int8",
                                           attn_impl="pallas_packed", noise_mode="zeros",
                                           save_images=False)
            S, dev = engine.image_size, engine.device
            path = os.path.join(EXPORT_DIR, f"{cfg}.pt2")
            _zero_launches(wrappers)
            t = time.perf_counter()
            program = EXP.export_engine(engine, B)  # one live forward, then the trace
            torch.cuda.synchronize()
            export_s = time.perf_counter() - t
            traced = _launch_counts(wrappers)
            t = time.perf_counter()
            torch.export.save(program, path)
            n_arrays = EXP.save_params(program, path + ".params.npz")
            save_s = time.perf_counter() - t
            mb = os.path.getsize(path) / 1e6
            npz_mb = os.path.getsize(path + ".params.npz") / 1e6
            nodes = dict(op_counts(program.graph))
            want_nodes = {op: EXPORT_LAUNCHES[kid] for op, kid in EXPORT_OPS.items()}
            log(f"  {point} B {B}: exported in {export_s:.1f} s (with one live forward, "
                f"whose launches K2 {traced['K2']}, K4 {traced['K4']}: the trace launched "
                f"and counted nothing), saved in {save_s:.1f} s: {mb:.1f} MB + params.npz "
                f"{npz_mb:.1f} MB ({n_arrays} arrays); caim nodes {nodes}")
            if nodes != want_nodes:
                raise AssertionError(f"(j) {point}: caim nodes {nodes} != {want_nodes}")
            want_live = {k: EXPORT_LAUNCHES.get(k, 0) for k in wrappers}
            want_live["K4"] = 12
            if traced != want_live:
                raise AssertionError(f"(j) {point}: launches around the export {traced} != "
                                     f"one live forward's {want_live}")
            del program
            t = time.perf_counter()
            loaded = EXP.load_program(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            inputs = EXP.serving_inputs(B, S, dev, EXP.roundtrip_images(B, S, dev))
            live = EXP.Serve(engine.model, engine.noise_mode)
            d0, c0 = live(*inputs)
            _zero_launches(wrappers)
            d1, c1 = loaded(*inputs)
            counts = _launch_counts(wrappers)
            want = {k: EXPORT_LAUNCHES.get(k, 0) for k in wrappers}
            bit_equal = bool(torch.equal(d0, d1) and torch.equal(c0, c1))
            rel = max(_rel(d1, d0), _rel(c1, c0))
            ok = all(np.allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                 rtol=EXP.RTOL, atol=EXP.ATOL) for a, b in ((d1, d0), (c1, c0)))
            finite = bool(torch.isfinite(d1).all() and torch.isfinite(c1).all()
                          and (d1 > 0).all() and ((c1 > 0) & (c1 < 1)).all())
            log(f"  {point}: loaded in {load_s:.1f} s, rebuilt from the npz; one forward of "
                f"the loaded program: depth {d1.min().item():.4f}..{d1.max().item():.4f}, "
                f"against the live forward rel {rel:.2e} (rtol {EXP.RTOL:.0e}, atol "
                f"{EXP.ATOL:.0e}) {'ok' if ok else 'FAIL'}, bit-equal {bit_equal}; launches "
                + ", ".join(f"{k} {counts[k]}" for k in wrappers if counts[k] or want[k]))
            if not ok or not finite:
                raise AssertionError(f"(j) {point}: the loaded program disagrees with the "
                                     f"live forward or gives invalid outputs")
            if counts != want:
                raise AssertionError(f"(j) {point}: launches of the loaded program {counts} "
                                     f"!= {want}")
            launches[point] = counts
            # the loaded program captured and replayed by the engine's helper
            graphs = CompiledForward(
                lambda inp, gen: loaded(inp["images"], {k[5:]: v for k, v in inp.items()
                                                        if k.startswith("exif/")}, inp["gidx"]),
                dev)
            flat_in = {"images": inputs[0], "gidx": inputs[2],
                       **{f"exif/{k}": v for k, v in inputs[1].items()}}
            graphs("loaded", flat_in)
            (capture_s,) = [e.capture_s for e in graphs.graphs.values()]
            (d2, c2), replay_counts, n_kernels = _replay_launches(
                f"(j) {point}", lambda: loaded(*inputs), lambda: graphs("loaded", flat_in),
                wrappers)
            replay_equal = bool(torch.equal(d2, d1) and torch.equal(c2, c1))
            log(f"  {point}: the loaded program captured in {capture_s:.2f} s "
                f"({graphs.pool_bytes() / 2 ** 20:.1f} MiB of pool); one replay against its "
                f"eager run: bit-equal {replay_equal}; launches a replay, read from its "
                f"trace ({n_kernels} caim kernels, the eager run's in its order) "
                + ", ".join(f"{k} {v}" for k, v in replay_counts.items() if v))
            if not replay_equal or replay_counts != want:
                raise AssertionError(f"(j) {point}: the loaded program's replay disagrees with "
                                     f"its eager run ({replay_counts} launches)")
            replay = lambda: graphs("loaded", flat_in)  # noqa: E731
            # times: a warm-up of each, then three of each in turns
            loaded(*inputs), live(*inputs), replay()
            t_loaded, t_live, t_replay = [], [], []
            for _ in range(3):
                t_live += _events_ms(lambda: live(*inputs), 1)
                t_loaded += _events_ms(lambda: loaded(*inputs), 1)
                t_replay += _events_ms(replay, 1)
            host_loaded = _host_enqueue_ms(lambda: loaded(*inputs))
            host_live = _host_enqueue_ms(lambda: live(*inputs))
            host_replay = _host_enqueue_ms(replay)
            med = {n: float(np.median(v)) for n, v in (("loaded", t_loaded), ("live", t_live),
                                                       ("replay", t_replay))}
            log(f"  {point} forward by CUDA events, median of 3 (range): loaded program "
                f"{med['loaded']:.3f} ms ({min(t_loaded):.3f}-{max(t_loaded):.3f}), live "
                f"{med['live']:.3f} ms ({min(t_live):.3f}-{max(t_live):.3f}), the loaded "
                f"program's graph {med['replay']:.3f} ms ({min(t_replay):.3f}-"
                f"{max(t_replay):.3f}); host enqueue {host_loaded:.3f} / {host_live:.3f} / "
                f"{host_replay:.3f} ms ({smi})")
            out[point] = {"batch": B, "export_s": export_s, "save_s": save_s,
                          "load_s": load_s, "artifact_mb": mb, "params_npz_mb": npz_mb,
                          "params_arrays": n_arrays, "caim_nodes": nodes,
                          "bit_equal": bit_equal, "rel_err": rel,
                          "forward_ms_loaded": med["loaded"], "forward_ms_live": med["live"],
                          "forward_ms_loaded_all": t_loaded, "forward_ms_live_all": t_live,
                          "host_enqueue_ms_loaded": host_loaded,
                          "host_enqueue_ms_live": host_live,
                          "graph_capture_s": capture_s, "graph_bit_equal": replay_equal,
                          "forward_ms_graph": med["replay"], "forward_ms_graph_all": t_replay,
                          "host_enqueue_ms_graph": host_replay}
            del engine, live, loaded, graphs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")
               or m == "export_model"]
    if foreign:
        raise AssertionError(f"phase (j) imported JAX, the JAX package or its script: {foreign}")
    out["torch"] = torch.__version__
    out["seconds"] = time.perf_counter() - t0
    log(f"phase (j) took {out['seconds']:.1f} s")
    return out, launches


# (point, config of phase (f), policy, batch, guided, uint8 images): phase (f)'s
# engine, guided on float images at B 8 and 16, exact and 2:0.35; at B 8 exact
# also unguided and on uint8 images (predict_paths_batched); the default policy
COMPILED_POINTS = (
    ("exact B8", "exact", "int8", 8, True, False),
    ("exact B16", "exact", "int8", 16, True, False),
    ("2:0.35 B8", "fast", "int8", 8, True, False),
    ("2:0.35 B16", "fast", "int8", 16, True, False),
    ("exact B8 unguided", "exact", "int8", 8, False, False),
    ("exact B8 uint8", "exact", "int8", 8, True, True),
    ("default B8", "exact", "default", 8, True, False),
)
COMPILED_RTOL, COMPILED_ATOL = 2e-5, 1e-6  # bit-equal expected


def _compiled_inputs(B, S, dev, uint8, guided, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if uint8:
        x = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev, dtype=torch.uint8)
    else:
        x = torch.randn((B, S, S, 3), generator=g, device=dev) * 0.5
    exif = {"camera_idx": torch.zeros(B, dtype=torch.int32, device=dev),
            "focal_length": torch.full((B,), 35.0, device=dev),
            "aperture": torch.full((B,), 2.8, device=dev),
            "iso": torch.full((B,), 200.0, device=dev)}
    gidx = (torch.arange(B, device=dev) % 9) if guided else None
    return x, exif, gidx


def phase_compiled(smi, packages):
    """(k) the engine's compiled forward (core/compiled.py): phase (f)'s
    engine, ViT-B 518 int8 pallas_packed with seeded weights and sampled
    noise, and the default policy; for each point the capture's seconds, one
    replay against the eager ``engine.model(...)`` with the replay's seed
    (rtol 2e-5 / atol 1e-6, bit-equal expected), the launches of a replay
    against the eager forward's, host time a replay beside the eager
    enqueue, both forwards by CUDA events (median of 3, range), the graphs
    held and the pool's bytes."""
    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference, load_config
    from cognitive_aim_tpu_torch.io.preprocess import normalize_u8
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS

    t0 = time.perf_counter()
    wrappers = _wrappers()
    log(f"(k) compiled forward on {smi}: {SERVE_CONFIG} (use_lora off), sampled noise; "
        + ", ".join(f"{p[0]} ({p[2]})" for p in COMPILED_POINTS))
    if packages["yaml"] is None or packages["PIL"] is None:
        raise RuntimeError("phase (k) needs PyYAML for the config and PIL for the images")
    os.makedirs(SERVE_DIR, exist_ok=True)
    out, launches, engines = {"card": smi}, {}, {}
    try:
        cfgs = _serving_configs(load_config(os.path.join(ROOT, SERVE_CONFIG)))
        _, paths = _image_files(np.random.RandomState(23), 8)
        for tag, cfg, policy, B, guided, uint8 in COMPILED_POINTS:
            if (cfg, policy) not in engines:
                engines[cfg, policy] = CognitiveAimInference(
                    cfgs[cfg], None, seed=0, policy=policy, attn_impl="pallas_packed",
                    noise_mode="sample", save_images=False)
            eng = engines[cfg, policy]
            S, dev = eng.image_size, eng.device
            n_before = len(eng.compiled.graphs)
            if uint8:  # the entry point that captures it: predict_paths_batched
                res = eng.predict_paths_batched(
                    paths, instructions=[INSTRUCTIONS[i % 9] for i in range(8)], batch_size=B)
                if not np.isfinite(np.asarray(res)).all():
                    raise AssertionError(f"(k) {tag}: predict_paths_batched gave {res}")
            x, exif, g = _compiled_inputs(B, S, dev, uint8, guided, seed=B + 7 * uint8)
            eng._forward(x, exif, g)  # captures where predict_paths_batched did not
            torch.cuda.synchronize()
            entry = list(eng.compiled.graphs.values())[n_before]
            x, exif, g = _compiled_inputs(B, S, dev, uint8, guided, seed=B + 100)
            seed = 0

            def eager():
                return eng.model(normalize_u8(x) if uint8 else x, exif, guidance=g,
                                 generator=torch.Generator(dev).manual_seed(seed),
                                 noise_mode=eng.noise_mode)

            got, replay, n_kernels = _replay_launches(
                f"(k) {tag}", eager, lambda: eng._forward(x, exif, g), wrappers)
            seed = eng._seed_of(eng._draws - 1)  # the last replay's
            want = eager()
            diff = max(float((getattr(got, f) - getattr(want, f)).abs().max())
                       for f in ("depth", "confidence", "attention"))
            bit_equal = all(torch.equal(getattr(got, f), getattr(want, f))
                            for f in ("depth", "confidence", "attention", "curiosity",
                                      "fused_features"))
            ok = all(np.allclose(getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy(),
                                 rtol=COMPILED_RTOL, atol=COMPILED_ATOL)
                     for f in ("depth", "confidence", "attention"))
            finite = bool(torch.isfinite(got.depth).all() and (got.depth > 0).all())
            layers, iters = eng.model.vit_cfg.num_layers, eng.arch.num_iterations
            want_launches = ({"K1": layers, "K6": iters} if policy == "default" else
                             {**{k: layers for k in ("K1", "K2", "K3", "K4", "K4a", "K4b")},
                              "K5": iters, "K6": iters})
            replay_fn = lambda: eng._forward(x, exif, g)  # noqa: E731
            eager(), replay_fn()
            host_replay = _host_enqueue_ms(replay_fn) * 1e3
            host_eager = _host_enqueue_ms(eager) * 1e3
            t_replay, t_eager = [], []
            for _ in range(3):
                t_eager += _events_ms(eager, 1)
                t_replay += _events_ms(replay_fn, 1)
            med = {n: float(np.median(v)) for n, v in (("replay", t_replay), ("eager", t_eager))}
            held = eng.compiled.describe()
            log(f"  {tag}: captured in {entry.capture_s:.2f} s ({entry.pool_bytes / 2 ** 20:.1f} "
                f"MiB added to the pool); a replay against the eager forward with its seed: "
                f"max |diff| {diff:.2e} (rtol {COMPILED_RTOL:.0e}, atol {COMPILED_ATOL:.0e}) "
                f"{'ok' if ok else 'FAIL'}, bit-equal {bit_equal}; launches a replay, read "
                f"from its trace ({n_kernels} caim kernels, the eager forward's in its "
                f"order): " + ", ".join(f"{k} {v}" for k, v in replay.items() if v)
                + f" (want {want_launches}); host "
                f"{host_replay:.0f} us a replay, eager enqueue {host_eager:.0f} us; device by "
                f"CUDA events, median of 3 (range): replay {med['replay']:.3f} ms "
                f"({min(t_replay):.3f}-{max(t_replay):.3f}), eager {med['eager']:.3f} ms "
                f"({min(t_eager):.3f}-{max(t_eager):.3f}); the engine holds {held['graphs']} "
                f"graphs, {held['pool_bytes'] / 2 ** 20:.1f} MiB of pool ({smi})")
            if not ok or not finite:
                raise AssertionError(f"(k) {tag}: the replay disagrees with the eager forward")
            if {k: v for k, v in replay.items() if v} != want_launches:
                raise AssertionError(f"(k) {tag}: launches a replay {replay} != "
                                     f"{want_launches}")
            launches[tag] = replay
            out[tag] = {"batch": B, "guided": guided, "uint8": uint8, "policy": policy,
                        "capture_s": entry.capture_s, "pool_mib": entry.pool_bytes / 2 ** 20,
                        "max_abs_diff": diff, "bit_equal": bit_equal,
                        "caim_kernels_replay": n_kernels, "host_us_replay": host_replay,
                        "host_us_eager": host_eager,
                        "ms_replay": med["replay"], "ms_eager": med["eager"],
                        "ms_replay_all": t_replay, "ms_eager_all": t_eager,
                        "graphs_held": held["graphs"], "pool_mib_held": held["pool_bytes"] / 2 ** 20}
    finally:
        engines.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (k) imported JAX or the JAX package: {foreign}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase (k) took {out['seconds']:.1f} s")
    return out, launches


# ------------------------------------------------- compiled training (l) ----
# phase (g)'s experiment_B trainer, eager and through its captured micro-steps
# from the same weights and generator seeds: 8 micro-steps (two updates at
# accumulation 4), two batches in turns; the alt_model pair (the token filter
# TP2_FILTER in training, alternating with the model without it) at
# ALT_LAYERS blocks, batch ALT_BATCH
COMPILED_TRAIN_STEPS = 8
ALT_LAYERS, ALT_BATCH = 4, 32


def _training_runs(tr, batches, eager, seed0, alt=None, steps=COMPILED_TRAIN_STEPS):
    """``steps`` micro-steps of ``tr`` from its current weights and a fresh
    optimizer: per step the loss, the device time by CUDA events and the
    host time of the call; the parameters after."""
    import torch

    losses, events, host = [], [], []
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        logs = tr.train_step(batches[i % len(batches)],
                             torch.Generator(device="cuda").manual_seed(seed0 + i),
                             fetch_logs=False, eager=eager, alt=alt)
        host.append((time.perf_counter() - t) * 1e6)
        b.record()
        losses.append(logs["loss"])
        events.append((a, b))
    torch.cuda.synchronize()
    return {"losses": [float(x) for x in losses],
            "ms": [a.elapsed_time(b) for a, b in events], "host_us": host,
            "params": {n: p.detach().clone() for n, p in tr.model.named_parameters()}}


def _runs_apart(a, b):
    """(largest loss difference, largest parameter difference) of two runs."""
    loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    par = max(float((a["params"][n] - b["params"][n]).abs().max()) for n in a["params"])
    return loss, par


def _compiled_pair(tag, tr, batches, seed0, start, wrappers, alt_launch=False,
                   steps=COMPILED_TRAIN_STEPS):
    """Eager twice and replayed twice from ``start`` (the first replayed run
    captures each micro-step kind at its first call): the runs against
    eager, eager's own spread, the launches of a replay read from a trace
    (``alt_launch``: of the alternate model's step), the times, the graphs
    and peak memory."""
    import torch

    def reset():
        with torch.no_grad():
            for n, p in tr.model.named_parameters():
                p.copy_(start[n])
        tr.reset_params()

    runs = {}
    for name, eager in (("eager", True), ("eager_again", True), ("captured", False),
                        ("replayed", False)):
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[name] = _training_runs(tr, batches, eager, seed0, steps=steps)
        runs[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name]["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    spread = _runs_apart(runs["eager"], runs["eager_again"])
    apart = {n: _runs_apart(runs[n], runs["eager"]) for n in ("captured", "replayed")}
    eager_bits = spread == (0.0, 0.0)
    ok = all(d == (0.0, 0.0) if eager_bits else
             (d[0] <= 2 * spread[0] and d[1] <= 2 * spread[1]) for d in apart.values())
    # one eager micro-step and one replay of a kind the runs captured (the
    # same model: ``alt_launch``), in one trace
    gen = torch.Generator(device="cuda").manual_seed(seed0)
    eager_fn = lambda: tr.train_step(batches[0], gen, fetch_logs=False, eager=True,  # noqa: E731
                                     alt=alt_launch)
    replay_fn = lambda: tr.train_step(batches[0], gen, fetch_logs=False,  # noqa: E731
                                      alt=alt_launch)
    _, replay, n_kernels = _replay_launches(f"(l) {tag}", eager_fn, replay_fn, wrappers)
    host_drained = {"eager": _host_enqueue_ms(eager_fn, 3) * 1e3,
                    "replay": _host_enqueue_ms(replay_fn, 3) * 1e3}
    held = tr.graphs.describe()

    def med(v):
        return float(np.median(v[1:])), float(min(v[1:])), float(max(v[1:]))

    out = {"bit_equal_eager_to_eager": eager_bits, "eager_spread_loss": spread[0],
           "eager_spread_params": spread[1],
           **{f"{n}_vs_eager_loss": d[0] for n, d in apart.items()},
           **{f"{n}_vs_eager_params": d[1] for n, d in apart.items()},
           "bit_equal_replayed": apart["replayed"] == (0.0, 0.0),
           "ms_eager": med(runs["eager"]["ms"]), "ms_replayed": med(runs["replayed"]["ms"]),
           "host_us_eager_in_run": med(runs["eager"]["host_us"]),
           "host_us_replay_in_run": med(runs["replayed"]["host_us"]),
           "host_us_eager": host_drained["eager"], "host_us_replay": host_drained["replay"],
           "peak_gib_eager": runs["eager"]["peak_gib"],
           "peak_gib_captured": runs["captured"]["peak_gib"],
           "peak_gib_replayed": runs["replayed"]["peak_gib"],
           "peak_reserved_gib_replayed": runs["replayed"]["peak_reserved_gib"],
           "losses_eager": runs["eager"]["losses"], "losses_replayed": runs["replayed"]["losses"],
           "graphs": [{"key": e["key"], "capture_s": e["capture_s"],
                       "pool_mib": e["pool_bytes"] / 2 ** 20, "replays": e["replays"]}
                      for e in held["each"]],
           "pool_mib": held["pool_bytes"] / 2 ** 20,
           "launches_replay": {k: v for k, v in replay.items() if v},
           "caim_kernels_replay": n_kernels}
    return out, ok, replay


def phase_training_compiled(smi):
    """(l) the trainer's compiled step: experiment_B's micro-steps eager and
    replayed from the same weights and seeds, and the alt_model pair."""
    import dataclasses

    import torch
    import yaml

    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        raw = yaml.safe_load(f)
    arch = resolve_model_config(raw, lookup="nested")
    B, accum = int(raw["training"]["batch_size"]), int(raw["training"]["accumulation_steps"])
    S = arch.image_size
    wrappers = _wrappers()
    log(f"(l) compiled training: {TRAIN_CONFIG} (ViT-B/14 {S}x{S}, LoRA rank {arch.lora_rank}, "
        f"{arch.num_iterations} focal iterations, batch {B}, accumulation {accum}, default "
        f"policy, pallas_packed), {COMPILED_TRAIN_STEPS} micro-steps eager and replayed, "
        f"per-block recompute on; the alt_model pair ({TP2_FILTER} in training and off) at "
        f"{ALT_LAYERS} blocks, batch {ALT_BATCH} ({smi})")
    os.environ["CAIM_TRAIN_REMAT"] = "1"  # read at each kind's capture
    out, launches = {"card": smi, "config": TRAIN_CONFIG, "batch": B, "accumulation": accum}, {}
    try:
        for tag in ("experiment_B", "alt_model_pair"):
            g = torch.Generator(device="cuda").manual_seed(5)
            if tag == "experiment_B":
                model = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed").init(g)
                alt_model, batch_size = None, B
            else:
                vit = dataclasses.replace(model.vit_cfg, num_layers=ALT_LAYERS)
                del tr, model
                torch.cuda.empty_cache()
                model = CognitiveAimModel(_filtered_arch(arch), DEFAULT_POLICY, "pallas_packed",
                                          vit_cfg=vit).init(g)
                alt_model = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed",
                                              vit_cfg=vit)
                batch_size = ALT_BATCH
            with torch.no_grad():  # lora_B 0 (its init) would leave lora_A's gradient 0
                for blk in model.backbone.layers:
                    blk.lora_B.normal_(0.0, 0.02, generator=g)
            cfg = TrainConfig.from_raw(raw, steps_per_epoch=4)
            tr = Trainer(model, cfg, output_dir=os.path.join(ROOT, "build", "smoke_training",
                                                             "compiled"), alt_model=alt_model)
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
            batches = [_train_batch(batch_size, S, torch.Generator(device="cuda")
                                    .manual_seed(60 + i)) for i in range(2)]
            got, ok, replay = _compiled_pair(tag, tr, batches, 70, start, wrappers,
                                             alt_launch=alt_model is not None)
            launches[tag] = replay
            out[tag] = got
            e, r = got["ms_eager"], got["ms_replayed"]
            log(f"  {tag}: {COMPILED_TRAIN_STEPS} micro-steps; eager against eager: "
                f"{'bit-equal' if got['bit_equal_eager_to_eager'] else 'apart'} (loss "
                f"{got['eager_spread_loss']:.2e}, parameters {got['eager_spread_params']:.2e}); "
                f"replayed against eager: loss {got['replayed_vs_eager_loss']:.2e}, parameters "
                f"{got['replayed_vs_eager_params']:.2e} (the capturing run: "
                f"{got['captured_vs_eager_loss']:.2e}, {got['captured_vs_eager_params']:.2e}; "
                f"bit-equal, or within 2x eager's spread) {'ok' if ok else 'FAIL'}")
            log(f"    micro-step by CUDA events, median of the steps after the first (range): "
                f"eager {e[0]:.1f} ms ({e[1]:.1f}-{e[2]:.1f}), replayed {r[0]:.1f} ms "
                f"({r[1]:.1f}-{r[2]:.1f}); host a call, the device drained first (mean of 3): "
                f"eager {got['host_us_eager']:.0f} us, replay {got['host_us_replay']:.0f} us "
                f"(in the runs, median: {got['host_us_eager_in_run'][0]:.0f}, "
                f"{got['host_us_replay_in_run'][0]:.0f} us); peak allocated eager "
                f"{got['peak_gib_eager']:.2f} GiB, replayed {got['peak_gib_replayed']:.2f} GiB "
                f"(reserved {got['peak_reserved_gib_replayed']:.2f}); launches a replay, read "
                f"from its trace ({got['caim_kernels_replay']} caim kernels, the eager step's "
                f"in its order): " + ", ".join(f"{k} {v}" for k, v in
                                                got["launches_replay"].items()) + f" ({smi})")
            for gr in got["graphs"]:
                log(f"    graph {gr['key']}: captured in {gr['capture_s']:.2f} s, "
                    f"{gr['pool_mib']:.1f} MiB added to the pool, {gr['replays']} replays")
            want = {"K1": 2 * model.vit_cfg.num_layers, "K6": arch.num_iterations}
            if tag == "experiment_B" and got["launches_replay"] != want:
                raise AssertionError(f"(l) {tag}: launches a replay {got['launches_replay']} "
                                     f"!= {want}")
            if not ok:
                raise AssertionError(f"(l) {tag}: the replayed micro-steps disagree with the "
                                     f"eager ones beyond eager's own spread")
            if not all(np.isfinite(got["losses_replayed"])):
                raise AssertionError(f"(l) {tag}: non-finite losses {got['losses_replayed']}")
        del tr, model, alt_model, start, batches
    finally:
        os.environ.pop("CAIM_TRAIN_REMAT", None)
        shutil.rmtree(os.path.join(ROOT, "build", "smoke_training"), ignore_errors=True)
        torch.cuda.empty_cache()
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (l) imported JAX or the JAX package: {foreign}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase (l) took {out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------------------------- ViT-L (m) ----
# the JAX package's second configuration, backbone_size: large (bench.py
# --backbone large): ViT-L 518 (24 blocks, D 1024, 16 heads of 64, MLP 4096)
# on the int8 policy, pallas_packed, 2 focal iterations, through the engine
# built from phase (f)'s config with the ViT-L backbone, exact and at the
# JAX package's 4:0.25 filter point, at its bench batches 8 and 24
VITL_DIR = os.path.join(ROOT, "build", "smoke_vitl")  # listed in .gitignore
VITL_FILTER = "4:0.25"
VITL_BATCHES = (8, 24)
# the trainer at ViT-L 518: experiment_B's recipe (LoRA 16 on attn_out, 6 focal
# iterations, default policy, recompute) at batch 8, accumulation 2, so that 3
# micro-steps hold both kinds (accumulate, update)
VITL_TRAIN_STEPS, VITL_TRAIN_BATCH, VITL_TRAIN_ACCUM = 3, 8, 2


def _vit_l_config():
    """Phase (f)'s serving config with the ViT-L backbone, exact (no token
    filter keys: the engine's ``token_filter`` sets them), adapters off, as
    JSON (JSON is YAML); returns its path."""
    import copy

    from cognitive_aim_tpu_torch.api import load_config

    cfg = copy.deepcopy(load_config(os.path.join(ROOT, SERVE_CONFIG)))
    for d in (cfg, cfg.setdefault("model", {})):
        d["use_lora"] = False
        d["backbone_size"] = "large"
        for k in [k for k in d if k.startswith("token_filter")]:
            del d[k]
    path = os.path.join(VITL_DIR, "vit_l.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _vit_l_images(B, S, seed):
    """Seeded normalised images, the dataset's EXIF and mixed instructions."""
    import torch

    x, exif, _ = _compiled_inputs(B, S, "cuda", False, True, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return x, exif, torch.randint(0, 9, (B,), generator=gen, device="cuda")


def _vit_l_kernel_times(n_kept):
    """Each kernel of the ViT-L path at its shape there (B 8, N 1370, D 1024,
    16 heads, F 4096; K1 also at the filtered stream's ``n_kept``; K5 and K6
    at the 1369 patches), held to its plain version, then timed, with phase
    (e)'s table of bounds."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(41)
    B, N, D, Fh, H = 8, 1370, 1024, 4096, 16
    table, _ = _kernel_table(B, N, D, Fh, H, g)
    times = {name: _time_kernel(name, *case, device=True) for name, case in table.items()}
    del table
    times["K1"]["at_kept"] = _time_kernel(
        "K1", *_attention_case(B, n_kept, D, H, torch.bfloat16, g), device=True)
    return times


def _vit_l_point(tag, eng, B, wrappers, trace):
    """One (engine, batch) point: the capture, one replay against the eager
    ``engine.model(...)`` (bit-equal expected), with ``trace`` the launches
    of a replay read from its trace, host time a replay and the eager
    enqueue, both forwards by CUDA events (median of 3, range), images/s."""
    import torch

    from cognitive_aim_tpu_torch.core.rng import NoiseMode

    S = eng.image_size
    n_before = len(eng.compiled.graphs)
    x, exif, g = _vit_l_images(B, S, seed=B)
    eng._forward(x, exif, g)  # the first forward of the signature: its capture
    torch.cuda.synchronize()
    entry = list(eng.compiled.graphs.values())[n_before]
    x, exif, g = _vit_l_images(B, S, seed=B + 100)

    def eager():
        return eng.model(x, exif, guidance=g, noise_mode=NoiseMode.ZEROS)

    def replay():
        return eng._forward(x, exif, g)

    if trace:
        got, launches, n_kernels = _replay_launches(f"(m) {tag}", eager, replay, wrappers)
    else:
        got, launches, n_kernels = replay(), None, None
    want = eager()
    fields = ("depth", "confidence", "attention", "curiosity", "fused_features")
    bit_equal = all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)
    _check_outputs(f"(m) {tag}", got, B, (S // 14) ** 2)
    host_replay, host_eager = _host_enqueue_ms(replay) * 1e3, _host_enqueue_ms(eager) * 1e3
    t_replay, t_eager = [], []
    for _ in range(3):
        t_eager += _events_ms(eager, 1)
        t_replay += _events_ms(replay, 1)
    med = {"replay": float(np.median(t_replay)), "eager": float(np.median(t_eager))}
    out = {"batch": B, "capture_s": entry.capture_s, "pool_mib": entry.pool_bytes / 2 ** 20,
           "bit_equal": bit_equal, "caim_kernels_replay": n_kernels,
           "host_us_replay": host_replay, "host_us_eager": host_eager,
           "ms_replay": med["replay"], "ms_eager": med["eager"],
           "ms_replay_all": t_replay, "ms_eager_all": t_eager,
           "images_per_s_replay": B / med["replay"] * 1e3,
           "images_per_s_eager": B / med["eager"] * 1e3}
    log(f"  {tag}: captured in {entry.capture_s:.2f} s ({out['pool_mib']:.1f} MiB added to the "
        f"pool); a replay bit-equal to the eager forward: {bit_equal}"
        + ("" if launches is None else
           f"; launches a replay, read from its trace ({n_kernels} caim kernels, the eager "
           f"forward's in its order): " + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        + f"; host {host_replay:.0f} us a replay, eager enqueue {host_eager:.0f} us; by CUDA "
        f"events, median of 3 (range): replay {med['replay']:.3f} ms ({min(t_replay):.3f}-"
        f"{max(t_replay):.3f}), {out['images_per_s_replay']:.1f} images/s; eager "
        f"{med['eager']:.3f} ms ({min(t_eager):.3f}-{max(t_eager):.3f}), "
        f"{out['images_per_s_eager']:.1f} images/s")
    if not bit_equal:
        raise AssertionError(f"(m) {tag}: the replay differs from the eager forward")
    return out, launches, (x, exif, g), eager


def _vit_l_plain(tag, model, x, exif, g, eager_out):
    """The kernel path's forward against the plain versions' on the same
    weights and inputs: depth and confidence within TOL_SLICE_BF16."""
    from cognitive_aim_tpu_torch.core.rng import NoiseMode

    with _plain_versions(model):
        plain = model(x, exif, guidance=g, noise_mode=NoiseMode.ZEROS)
    rd, rc = _rel(eager_out.depth, plain.depth), _rel(eager_out.confidence, plain.confidence)
    ok = rd <= TOL_SLICE_BF16 and rc <= TOL_SLICE_BF16
    log(f"  {tag} kernels vs plain: depth rel {rd:.2e}, confidence rel {rc:.2e} "
        f"(tol {TOL_SLICE_BF16:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(m) {tag}: the kernel path disagrees with the plain path")
    return {"depth_rel": rd, "confidence_rel": rc}


def phase_vit_l(smi, packages):
    """(m) ViT-L 518: the int8 forward through the engine exact and at
    4:0.25, B 8 and 24, eagerly and replayed; kernels against plain
    versions; the launches of a replay, also under CAIM_FUSE_AOMLP=1; the
    strict forward and the int8-vs-f32 worst-instruction delta on seeded
    weights; 3 captured training micro-steps against eager; each kernel's
    time at its ViT-L shape."""
    import dataclasses

    import torch
    import yaml

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.certify.policy_delta import synth_images, tables
    from cognitive_aim_tpu_torch.convert import load_flat_params
    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY, STRICT_F32
    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.io.preprocess import normalize_np
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    wrappers = _wrappers()
    log(f"(m) ViT-L 518 on {smi}: {SERVE_CONFIG} with backbone_size large (use_lora off), "
        f"int8, pallas_packed, noise zeros, exact and {VITL_FILTER}, B "
        f"{' and '.join(map(str, VITL_BATCHES))}; the strict forward; the trainer")
    if packages["yaml"] is None:
        raise RuntimeError("phase (m) needs PyYAML for the config")
    os.makedirs(VITL_DIR, exist_ok=True)
    out, launches, engines = {"card": smi, "config": SERVE_CONFIG, "backbone_size": "large"}, {}, {}
    try:
        cfg_path = _vit_l_config()
        with torch.no_grad():
            for name, spec in (("exact", ""), (VITL_FILTER, VITL_FILTER)):
                t1 = time.perf_counter()
                engines[name] = eng = CognitiveAimInference(
                    cfg_path, None, seed=0, policy="int8", attn_impl="pallas_packed",
                    noise_mode="zeros", save_images=False, token_filter=spec)
                torch.cuda.synchronize()
                vc = eng.model.vit_cfg
                shape = (vc.num_layers, vc.hidden_size, vc.num_heads, vc.mlp_dim, eng.image_size)
                log(f"  engine {name}: built in {time.perf_counter() - t1:.1f} s, "
                    f"{sum(v.size for v in eng.params.values()) / 1e6:.1f} M parameters; "
                    f"blocks, D, heads, MLP, image {shape}")
                if shape != (24, 1024, 16, 4096, 518) or not eng.model.backbone.layers[0].quantized:
                    raise AssertionError(f"(m) engine {name}: not the int8 ViT-L 518 ({shape})")
            layers, iters = 24, eng.arch.num_iterations
            n_kept = 1 + round(0.25 * 1369) + 1  # CLS, the kept patches, the context token
            chained = {k: layers for k in ("K1", "K2", "K3", "K4", "K4a", "K4b")}
            want = {**chained, "K5": iters, "K6": iters}
            fwd = {}
            for name, eng in engines.items():
                for B in VITL_BATCHES:
                    # a replay's launches, read from its trace at B 8: the graphs
                    # of other batches run the same code (each trace costs ~7 s)
                    tag = f"{name} B{B}"
                    out[tag], replay, inputs, eager = _vit_l_point(tag, eng, B, wrappers, B == 8)
                    if B != 8:
                        continue
                    if {k: v for k, v in replay.items() if v} != want:
                        raise AssertionError(f"(m) {tag}: launches a replay {replay} != {want}")
                    launches[tag] = replay
                    fwd[name] = inputs, eager()
                    out[tag]["vs_plain"] = _vit_l_plain(tag, eng.model, *inputs, fwd[name][1])
            # the filter: the stream lengths per block, the frozen dropped
            # tokens and the kept sets of kernels and plain versions
            filt = engines[VITL_FILTER].model
            x, _, g = fwd[VITL_FILTER][0]
            _check_filtered_backbone(f"(m) {VITL_FILTER} B8", filt, x, g, (1370, n_kept))
            # CAIM_FUSE_AOMLP=1: K12 in place of K3 -> K4, captured anew
            eng = engines["exact"]
            os.environ["CAIM_FUSE_AOMLP"] = "1"
            eng.compiled.graphs.clear()
            try:
                out["fused B8"], replay, inputs, eager = _vit_l_point(
                    "exact B8, CAIM_FUSE_AOMLP=1", eng, 8, wrappers, True)
                fused_want = {"K1": layers, "K2": layers, "K12": layers, "K5": iters,
                              "K6": iters}
                if {k: v for k, v in replay.items() if v} != fused_want:
                    raise AssertionError(f"(m) fused: launches a replay {replay} != "
                                         f"{fused_want}")
                launches["fused B8"] = replay
                fused = eager()
                out["fused B8"]["vs_plain"] = _vit_l_plain("fused B8", eng.model, *inputs, fused)
            finally:
                os.environ.pop("CAIM_FUSE_AOMLP", None)
                eng.compiled.graphs.clear()
            unfused = fwd["exact"][1]
            rf = _rel(fused.depth, unfused.depth)
            log(f"  fused against unfused: depth rel {rf:.2e} (tol {TOL_K12_SPLIT:.0e})")
            if rf > TOL_K12_SPLIT:
                raise AssertionError("(m) the fused ViT-L forward strays from the unfused one")
            out["fused B8"]["vs_unfused_depth_rel"] = rf

            # the strict policy on the same weights, B 8; then the int8 (and
            # int8 + filter) against f32 worst-instruction depth AbsRel
            strict = load_flat_params(
                CognitiveAimModel(eng.arch, STRICT_F32, "pallas_packed"), eng.params)
            strict.prepare_params()
            x, exif, g = fwd["exact"][0]
            _zero_launches(wrappers)
            a = strict(x, exif, guidance=g, noise_mode=NoiseMode.ZEROS)
            strict_launches = _launch_counts(wrappers)
            want_f32 = {"K1": layers, "K6": iters}
            log("  strict f32 B8 launches in one forward (the f32 programs): " + ", ".join(
                f"{k} {v}" for k, v in strict_launches.items() if v) + f" (want {want_f32})")
            if {k: v for k, v in strict_launches.items() if v} != want_f32:
                raise AssertionError(f"(m) strict launches {strict_launches} != {want_f32}")
            launches["strict B8"] = strict_launches
            strict.attn_impl = "plain"
            b = strict(x, exif, guidance=g, noise_mode=NoiseMode.ZEROS)
            strict.attn_impl = "pallas_packed"
            rd = max(_rel(a.depth, b.depth), _rel(a.confidence, b.confidence))
            ra = max_err(a.attention, b.attention)
            log(f"  strict f32 B8 kernels vs plain: depth/confidence rel {rd:.2e}, attention "
                f"abs {ra:.2e} (tol {TOL_SLICE_F32:.0e})")
            if rd > TOL_SLICE_F32 or ra > TOL_SLICE_F32:
                raise AssertionError("(m) the strict kernel path disagrees with the plain path")
            t_strict = _events_ms(lambda: strict(x, exif, guidance=g,
                                                 noise_mode=NoiseMode.ZEROS), 3)
            norm = torch.from_numpy(normalize_np(synth_images(8, 518, seed=0))).cuda()
            models = {"f32": strict, "int8": engines["exact"].model,
                      "int8+tf": engines[VITL_FILTER].model}
            preds = {n: {} for n in models}
            confs = {n: {} for n in models}
            for gi, gname in enumerate(INSTRUCTIONS):
                gv = torch.full((8,), gi, dtype=torch.long, device="cuda")
                for n, m in models.items():
                    o = m(norm, exif, guidance=gv, noise_mode=NoiseMode.ZEROS)
                    preds[n][gname] = o.depth[:, 0].double().cpu().numpy()
                    confs[n][gname] = o.confidence[:, 0].double().cpu().numpy()
            delta = tables(preds, confs)
            out["strict B8"] = {"vs_plain_rel": rd, "attention_abs": ra,
                                "ms": float(np.median(t_strict)), "ms_all": t_strict,
                                "worst_instruction_absrel": {n: d["worst"]
                                                             for n, d in delta.items()}}
            log(f"  strict f32 B8: {out['strict B8']['ms']:.2f} ms a forward by CUDA events; "
                f"worst-instruction depth AbsRel against it on seeded weights (8 structured "
                f"scenes x 9 instructions; no budget: the 1% budget is for trained weights): "
                f"int8 {delta['int8']['worst']:.5f}, int8 + {VITL_FILTER} "
                f"{delta['int8+tf']['worst']:.5f}")
            del strict, models, a, b, eng, filt, inputs, eager, fused, unfused
        engines.clear()
        fwd.clear()
        torch.cuda.empty_cache()

        # the trainer: 3 micro-steps at ViT-L 518, B 8, eager and replayed
        with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
            raw = yaml.safe_load(f)
        raw["training"]["accumulation_steps"] = VITL_TRAIN_ACCUM
        arch = dataclasses.replace(resolve_model_config(raw, lookup="nested"),
                                   backbone_size="large", image_size=518)
        gen = torch.Generator(device="cuda").manual_seed(5)
        model = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed").init(gen)
        with torch.no_grad():  # lora_B 0 (its init) would leave lora_A's gradient 0
            for blk in model.backbone.layers:
                blk.lora_B.normal_(0.0, 0.02, generator=gen)
        os.environ["CAIM_TRAIN_REMAT"] = "1"
        try:
            tr = Trainer(model, TrainConfig.from_raw(raw, steps_per_epoch=4),
                         output_dir=os.path.join(VITL_DIR, "training"))
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
            batches = [_train_batch(VITL_TRAIN_BATCH, 518, torch.Generator(device="cuda")
                                    .manual_seed(80 + i)) for i in range(2)]
            got, ok, replay = _compiled_pair("ViT-L training", tr, batches, 90, start, wrappers,
                                             steps=VITL_TRAIN_STEPS)
        finally:
            os.environ.pop("CAIM_TRAIN_REMAT", None)
        launches["training"] = replay
        out["training"] = got
        e, r = got["ms_eager"], got["ms_replayed"]
        log(f"  training, ViT-L 518 B{VITL_TRAIN_BATCH}, accumulation {VITL_TRAIN_ACCUM}, "
            f"{VITL_TRAIN_STEPS} micro-steps: replayed against eager: loss "
            f"{got['replayed_vs_eager_loss']:.2e}, parameters {got['replayed_vs_eager_params']:.2e} "
            f"(eager against eager {got['eager_spread_loss']:.2e}, "
            f"{got['eager_spread_params']:.2e}) {'ok' if ok else 'FAIL'}; micro-step by CUDA "
            f"events (median of the steps after the first, range): eager {e[0]:.1f} ms "
            f"({e[1]:.1f}-{e[2]:.1f}), replayed {r[0]:.1f} ms ({r[1]:.1f}-{r[2]:.1f}); peak "
            f"allocated eager {got['peak_gib_eager']:.2f} GiB, replayed "
            f"{got['peak_gib_replayed']:.2f} GiB (reserved {got['peak_reserved_gib_replayed']:.2f}); "
            f"launches a replay: " + ", ".join(f"{k} {v}" for k, v in
                                               got["launches_replay"].items()))
        want_train = {"K1": 2 * layers, "K6": arch.num_iterations}
        if got["launches_replay"] != want_train:
            raise AssertionError(f"(m) training: launches a replay {got['launches_replay']} != "
                                 f"{want_train}")
        if not ok or not got["bit_equal_replayed"]:
            raise AssertionError("(m) training: the replayed micro-steps differ from eager")
        del tr, model, start, batches
        torch.cuda.empty_cache()
        times = _vit_l_kernel_times(n_kept)
    finally:
        engines.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(VITL_DIR, ignore_errors=True)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"phase (m) imported JAX or the JAX package: {foreign}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase (m) took {out['seconds']:.1f} s")
    return out, launches, times


KERNELS = {
    # id: (wrapper name, source, TPU kernel body it replaces)
    # K1, K7 and K8 launch one bf16 program, flash_wgmma.cu (their f32
    # kernels stay in the files of their C entries)
    "K1": ("flash_attention_packed", "flash_wgmma.cu", "flash_attention.py:388"),
    "K2": ("int8_qkv_proj_ln", "int8_block.cu", "int8_block.py:143"),
    "K3": ("int8_out_residual", "int8_block.cu", "int8_block.py:427"),
    "K4": ("int8_mlp_ln", "int8_block.cu", "int8_block.py:312"),
    "K4a": ("int8_fc1_gelu_ln", "int8_block.cu", "int8_block.py:218"),
    "K4b": ("int8_out_residual_prequant", "int8_block.cu", "int8_block.py:256"),
    "K5": ("int8_qkv_proj", "int8_block.cu", "int8_block.py:110"),
    "K6": ("focal_attention_fused", "focal_attention.cu", "focal_attention.py:52"),
    "K7": ("flash_attention_packed_bias", "flash_wgmma.cu", "flash_attention.py:149"),
    # K10 and K10b: the int8 instantiation of K1's program (their C entry
    # stays in flash_attention_i8qk.cu)
    "K10": ("flash_attention_packed_i8qk", "flash_wgmma.cu", "flash_attention.py:451"),
    "K10b": ("flash_attention_packed_i8qk_bias", "flash_wgmma.cu", "flash_attention.py:250"),
    # the quantisation K10 and K10b read, one launch each for q and k together;
    # the JAX package leaves it to XLA, outside its kernels
    "Q": ("quantize_rows", "int8_block.cu", "flash_attention.py:433"),
    "K8": ("flash_attention", "flash_wgmma.cu", "flash_attention.py:44"),
    # K13 and K14 have no caller in either package's models: their launches on
    # the main path are 0, and phase (c) holds them against their plain versions
    "K13": ("int8_proj", "int8_block.cu", "int8_block.py:83"),
    "K14": ("int8_fc1_gelu", "int8_block.cu", "int8_block.py:183"),
    "K15": ("int8_gemm_fused", "int8_block.cu", "int8_gemm.py:31"),
    # the fused variants of the chained int8 block. K12 runs in the model under
    # CAIM_FUSE_AOMLP=1 (slices F1, F2); K9 and K11 have no model route in either
    # package: their launches are those of the 12 blocks assembled by hand. K9
    # is the int8 instantiation of K1's program on (row, head) scales (its C
    # entry in flash_attention_i8qk.cu), after its quantiser Qh, which the TPU
    # kernel runs inside its body (_quant_rows)
    "K9": ("flash_attention_packed_int8", "flash_wgmma.cu", "flash_attention.py:356"),
    "Qh": ("quantize_heads", "int8_block.cu", "flash_attention.py:349"),
    # K11: the OUT_RES instantiation of K1's program, a thread-block cluster
    # over the heads of a 64-row tile (its C entry in flash_attention_out_res.cu)
    "K11": ("flash_attention_packed_out_res", "flash_wgmma.cu", "flash_attention.py:645"),
    "K12": ("int8_attnout_mlp_ln", "int8_fused_block.cu", "int8_block.py:365"),
}
# the strict policy's f32 programs: (name, source, TPU kernel body, the
# wrapper whose launches in the strict forward at 224x224 are theirs)
F32_KERNELS = {
    "K1f32": ("flash_f32_kernel", "flash_f32.cuh", "flash_attention.py:388", "K1"),
    "K7f32": ("flash_f32_kernel<bias>", "flash_f32.cuh", "flash_attention.py:149", "K7"),
    "K8f32": ("flash_bnhd_f32_kernel", "flash_f32.cuh", "flash_attention.py:44", "K8"),
    "K6f32": ("focal_f32_scores_kernel + focal_f32_attend_kernel", "focal_attention.cu",
              "focal_attention.py:52", "K6"),
}
# the path whose run gives a kernel's ``launches``: the unfiltered int8 slice,
# or the first filtered or adapter slice that reaches the kernel
LAUNCHES_FROM = {"K7": "2", "K10": "3", "K10b": "3", "Q": "3", "K8": "A2", "K15": "A3",
                 "K9": "K9", "Qh": "K9", "K11": "K11", "K12": "F1"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import cognitive_aim_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    smi = phase_device()
    packages = host_packages()
    log("host packages of the serving path (f): " + ", ".join(
        f"{k} {v or 'missing'}" for k, v in packages.items() if k != "native loader error")
        + (f" ({packages['native loader error']})" if packages["native loader error"] else ""))
    phase_build()
    if "--parallel-only" in sys.argv[1:]:
        parallel, _ = phase_parallel(smi, packages)
        log(f"parallel {json.dumps(parallel, default=float)}")
        log(f"parallel only: phases (c)-(h) and (j) were not driven, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--compiled-only" in sys.argv[1:]:
        with torch.no_grad():
            compiled, _ = phase_compiled(smi, packages)
        log(f"compiled {json.dumps(compiled, default=float)}")
        log(f"compiled only: phases (c)-(j) were not driven, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--training-compiled-only" in sys.argv[1:]:
        compiled_training, _ = phase_training_compiled(smi)
        log(f"training_compiled {json.dumps(compiled_training, default=float)}")
        log(f"compiled training only: phases (c)-(k) were not driven, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--vit-l-only" in sys.argv[1:]:
        vit_l, _, vit_l_times = phase_vit_l(smi, packages)
        log(f"vit_l {json.dumps({**vit_l, 'kernel_times': vit_l_times}, default=float)}")
        log(f"ViT-L only: phases (c)-(l) were not driven, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--export-only" in sys.argv[1:]:
        with torch.no_grad():
            export, _ = phase_export(smi, packages)
        log(f"export {json.dumps(export, default=float)}")
        log(f"export only: phases (c)-(i) were not driven, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    log("(c) kernels vs plain versions")
    errs = phase_kernels()
    phase_flash_body()
    errs.update(phase_f32_programs())
    errs.update(phase_i8qk_program())
    errs.update(phase_int8_kernels())
    phase_int8_gemm()
    errs.update(phase_filter_kernels())
    errs.update(phase_adapter_kernels())
    errs.update(phase_fused_kernels())
    phase_k11_kernel()
    phase_k12_kernel()
    phase_fc1_and_focal()
    if "--kernels-only" in sys.argv[1:]:
        phase_kernel_times(smi)
        log(f"kernels only: no slice was driven, {time.perf_counter() - t_start:.1f} s")
        return 0
    with torch.no_grad():  # inference: no phase before (g) builds an autograd graph
        default, int8, launches, launches_default, launches_strict, reqs = phase_slices()
        filtered, launches_filtered = phase_filtered_slices(reqs)
        adapters, launches_adapters = phase_adapter_slices(reqs)
        launches_fused, x0 = phase_fused_slices(int8, filtered["1"], reqs)
        times = phase_kernel_times(smi)
        phase_forward_times(default, int8, filtered, adapters)
        phase_fused_times(int8, filtered["1"], x0)
        del default, int8, filtered, adapters
        t_serve = time.perf_counter()
        serving = phase_serving(smi, packages)
    log(f"serving {json.dumps(serving)}")
    log(f"phase (f) took {time.perf_counter() - t_serve:.1f} s")
    torch.cuda.empty_cache()
    training, launches_training = phase_training(smi)
    log(f"training {json.dumps(training)}")
    certification, launches_cert, launches_cert_f32 = phase_certification(smi)
    log(f"certification {json.dumps(certification, default=float)}")
    torch.cuda.empty_cache()
    parallel, launches_parallel = phase_parallel(smi, packages)
    log(f"parallel {json.dumps(parallel, default=float)}")
    torch.cuda.empty_cache()
    with torch.no_grad():
        export, launches_export = phase_export(smi, packages)
    log(f"export {json.dumps(export, default=float)}")
    torch.cuda.empty_cache()
    with torch.no_grad():
        compiled, launches_compiled = phase_compiled(smi, packages)
    log(f"compiled {json.dumps(compiled, default=float)}")
    torch.cuda.empty_cache()
    compiled_training, launches_training_compiled = phase_training_compiled(smi)
    log(f"training_compiled {json.dumps(compiled_training, default=float)}")
    torch.cuda.empty_cache()
    vit_l, launches_vit_l, vit_l_times = phase_vit_l(smi, packages)
    log(f"vit_l {json.dumps(vit_l, default=float)}")
    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "cognitive_aim_tpu")]
    if foreign:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {foreign}")
    kernels = [
        {"id": kid, "name": name, "route": "cuda",
         "source": f"cognitive_aim_tpu_torch/csrc/{src}",
         "replaces": f"cognitive_aim_tpu/kernels/{body}",
         "launches": ({**launches_filtered, **launches_adapters,
                       **launches_fused}[LAUNCHES_FROM[kid]]
                      if kid in LAUNCHES_FROM else launches)[kid],
         "launches_default_policy": launches_default[kid],
         "launches_filtered_slices": {n: c[kid] for n, c in launches_filtered.items()},
         "launches_adapter_slices": {n: c[kid] for n, c in launches_adapters.items()},
         "launches_fused_slices": {n: c[kid] for n, c in launches_fused.items()},
         "launches_training": launches_training[kid],
         "launches_certification": launches_cert[kid],
         "launches_parallel": {n: c[kid] for n, c in launches_parallel.items()},
         "launches_export": {n: c[kid] for n, c in launches_export.items()},
         "launches_compiled": {n: c[kid] for n, c in launches_compiled.items()},
         "launches_training_compiled": {n: c[kid]
                                        for n, c in launches_training_compiled.items()},
         "launches_vit_l": {n: c[kid] for n, c in launches_vit_l.items() if n != "strict B8"},
         **times[kid], "max_abs_err": errs[kid], "vit_l": vit_l_times.get(kid)}
        for kid, (name, src, body) in KERNELS.items()]
    kernels += [
        {"id": kid, "name": name, "route": "cuda",
         "source": f"cognitive_aim_tpu_torch/csrc/{src}",
         "replaces": f"cognitive_aim_tpu/kernels/{body}",
         "launches": launches_strict[wrapper], "launches_from": "strict f32 224x224",
         "launches_certification": launches_cert_f32[wrapper],
         # the exported program and the compiled engine run bf16 attention, no f32 program
         "launches_export": {n: 0 for n in launches_export},
         "launches_compiled": {n: 0 for n in launches_compiled},
         "launches_training_compiled": {n: 0 for n in launches_training_compiled},
         # phase (m): the strict ViT-L forward runs the f32 programs of K1 and K6
         "launches_vit_l": {n: c[wrapper] if n == "strict B8" else 0
                            for n, c in launches_vit_l.items()},
         **times[kid], "max_abs_err": errs[kid], "vit_l": vit_l_times.get(kid)}
        for kid, (name, src, body, wrapper) in F32_KERNELS.items()]
    from cognitive_aim_tpu_torch.utils import profiling

    log(f"total {time.perf_counter() - t_start:.1f} s (the last replay trace waited "
        f"{profiling._SETTLE} s around its call)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
