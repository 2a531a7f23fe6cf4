#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-eval PARENT_DIR
    python3 chip_smoke.py --compare-bn PARENT_DIR
    python3 chip_smoke.py --compare-ingest-mask PARENT_DIR

Run from the repository root on a machine with one NVIDIA card and the CUDA
toolkit (nvcc on PATH or under /usr/local/cuda).  It needs no network, and
imports nothing of JAX or of the JAX package.  Phases, each printing one
line (phase 2 adds nvcc's per-kernel register report):

  1. card   -- nvidia-smi's name and power limit, torch's device name;
  2. build  -- build (or load) the hand-written kernels from csrc/;
  2 also prints, per head width, ptxas's registers and spills of the
     tensor-core bodies of K1/K12 and K3/K4 and of K3/K4's f32 scalar
     bodies, and those of K11's and K10's bodies (the warpgroup-MMA ones,
     K10's per number of 64-row tiles a warpgroup holds, and the f32
     ones), and fails if a tensor-core body spills; and those of K7/K8's
     bodies (per dtype and route), of K5's body and of K6's four (per
     dtype and route), failing on a spill, with K5's and K6's static SASS
     counts (``cuobjdump -sass``) by pipe;
  3. kernels vs plain versions on the card, at the recognize path's shapes:
     K2 stack_frames bit-exact; K1 small_mha_flat within K1_TOL, f32 and
     bf16, at d = 64 and at the other head widths it is built for (16, 32,
     128); device times of both and of scaled_dot_product_attention;
  3b. the training kernels vs their plain versions at the B=240 train
     step's shapes, f32 and bf16: K5 dropout_keep_mask_flat bit-exact
     against the plain Philox, keep fraction KEEP_FRACTION; K3
     small_mha_dropout_fwd_flat and K4 small_mha_dropout_bwd_flat within
     TRAIN_TOL given K5's mask; K3 at rate 0 against K1; times of all
     three, their plain versions and scaled_dot_product_attention's
     forward and backward, with their bounds (K5's on the integer pipes);
     K5 bit-exact at MASK_SHAPES (one element, n not a multiple of 16, one
     key, one head, one query row, the grid-stride loop); the batch-row map
     of a data-parallel process (process 1 of 2, the decoder's two
     directions in one launch): K5 bit-exact against the plain Philox and
     against its rows of the one-process mask, K3/K4 on it within
     TRAIN_TOL; with it the head map of model process 1 of 2 of a
     tensor-parallel step (heads 4-7 of 8, h0 = 4): K5 bit-exact against the
     plain Philox and equal to those heads of the one-process mask, K3/K4
     within TRAIN_TOL of their plain versions and equal, bit for bit, to
     those heads' columns of the one-process launch; K3/K4/K5's times at
     h0 = 0 beside the tree's before the head offset (H0_BEFORE_MS, a
     record); K5's time queued back to back, and the launch floor split
     (launch_floor);
     then K3/K4 at the other head
     widths they are built for (16, 32, 128) and at lengths past one tile
     of 32 keys (70, 150, one query row against 300 keys, and the longest
     each width takes: 153, 139, 116, 84 at d = 16, 32, 64, 128);
     max-pool tie gradients, card vs CPU;
  4. recognize slice at the full config.sbl() width with seeded random
     weights: kernel path vs plain path at B=32 in f32 (TF32 off) and bf16,
     then the bf16 recognize path at B=512: launch counts, output checks;
  4b. the tiny preset (d_k = 16) through recognize (f32, bf16, f32 with
     the fused decoder layer, and f32 and bf16 with both eval-side switches,
     K10 at C = 8, S = 8) and one f32 train step, each against the plain
     path: recognize launches K1 (and K11, K10), the train step K2, K3 and
     K4, as counted;
  3c. the training entry point's kernels vs their plain versions at its
     shapes, f32 and bf16: K6 ingest_train at (240,30,96,96) -> 88 with
     attach_plans plans and n_frames padding, bit-exact on its vector route
     (16-byte pieces), and at INGEST_CASES (the tiny preset's crop on the
     vector route; a crop of no whole pieces, rows of no whole words,
     clips at an odd byte offset and, through the C entry, an output at an
     element offset on the scalar route); K7 channel_sums and
     K8 channel_sums_pair on the frontend's five BatchNorm shapes at
     B*T = 7200 frames and on the B=16 check's layer4 shape (the 16-byte
     route), and on BN_SCALAR_CASES (rows of odd length, rows at an odd
     element offset: the scalar route), within STAT_TOL of the sum of
     magnitudes and bit-identical over two calls; each shape's time, share
     of its bound, plain and library times, and the bf16 sums per step;
  5. train slice at the full config.sbl() width: kernel path vs plain path
     for one step at B=TRAIN_CHECK_BATCH, f32 and bf16 (loss, every
     gradient, BN running statistics); the bf16 step at B=240 through
     training.trainer.train_steps (launch counts, finite loss, every
     parameter moved), then TRAIN_WARMUP + TRAIN_STEPS steps on one resident
     batch: finite losses, peak memory;
  6. the training entry point at the full width with PALLAS_INGEST=1 and
     PALLAS_BN=1: kernel path vs plain path for one step at
     B=TRAIN_CHECK_BATCH (phase 5's tolerances); `cli train` for two B=240
     steps and a validation (launch counts per step, finite loss, the
     checkpoint and its _best mirror); `cli test` on that checkpoint (its
     WER/PER equal the in-memory model's); a stage-2 transfer step with
     frontend and encoder frozen (bit-identical) and the decoder moving; the
     B=240 step with the switches off and on, one turn each: finite losses,
     peak memory;
  3d. the eval-side kernels vs their plain versions: K9 stack_frames_u8 at
     (512,30,96,96), bit-exact in f32 and bf16, and against
     device_ingest + K2; K10 fused_resblock on the four shape classes of
     ResNet-18's five eligible blocks at N = 15360 frames in bf16 (f32 at
     N = RESBLOCK_F32_FRAMES: the CUDA-core f32 GEMM is slow on the small
     planes, and the check needs no more) within RESBLOCK_TOL; K11
     fused_decoder_layer at L in {3, 17}, with and without the (L, L) bias,
     both directions, B=512, f32 and bf16, within LAYER_TOL of its plain
     version (and, printed, against the module path); times of kernel, plain
     version and the module (library) composition; K11 at d_k = 128 (4
     heads) within LAYER_TOL; K1 at Tq=1 runs in phase 3; the per-batch
     sums of K10; K10 at C = 12 and K11 at d_model 40 (2 heads of 20) in
     bf16, whose weights TMA cannot map (rows not a multiple of 16 bytes:
     the ring's register path), within RESBLOCK_TOL / LAYER_TOL;
  7. path A, `sbl` recognize at the full width with both eval-side switches
     on and K9 as the ingest: switches on vs off at B=SWITCH_CHECK_BATCH
     (first-step logits, token agreement), then B=512: launches per batch
     (K9 1, K10 5, K11 96, K1 in the encoder only) and output checks;
  8. path B, the unidirectional workloads through `cli test` at the full
     width: a seeded lrw1000 model saved as a checkpoint, evaluated greedily
     and with --beam-size 5 --bigram-lm at the preset's batch (WER/PER equal
     to the in-memory model's; K13 launched a decoder layer and step of each
     eval batch), beam 1 == greedy tokens and beam 5's scores finite and
     sorted, `lrw` greedy, `sbl` --beam-size 5;
  3e. the layout twins and K12 vs their plain versions, d = 64, f32 and
     bf16: fused_small_mha at (1024,17,8,64) causal, bit-identical to K1 on
     the flat view and within K1_TOL of its plain version; small_mha's
     gradients (K1 forward, K4 at rate 0 backward) at (480,17,8,64) causal
     within TRAIN_TOL; the dropout twins at (480,17,8,64) causal and at
     T = 31 and 32, bit-identical to K3 and K4 on the views and within
     TRAIN_TOL of their plain versions given dropout_keep_mask's mask;
     dropout_keep_mask bit-exact against the plain Philox; K12 fused_mha at
     (512,8,17,64) and (512,8,30,64) with per-head, head-broadcast and no
     bias within K1_TOL; times of each, its plain version and the
     scaled_dot_product_attention forward or backward;
  3f. K13 cached_attention_step vs its plain version at each cached
     decoder's shape (K13_SHAPES: the CTC beam's (2560, 33, 12x64), the
     lrw1000 beam's (2560, 17, 8x64) and greedy decoder's (512, 17, 8x64)),
     f32 and bf16 within K1_TOL at steps 0, L // 2 and L - 1, on caches
     full of values: afterwards the caches equal the plain version's bit
     for bit (slot ``step`` holds k_new / v_new, no other slot written);
     in bf16 its time at those steps beside its bytes bound, the plain
     version's and one scaled_dot_product_attention call on the sliced
     cache, and its time summed over every step and layer of a batch
     against the summed bound (phase 8 and 11a count its launches);
  9. path C, `lrw1000` training at the full width, bf16, B=240: kernel path
     vs plain path for one step at B=TRAIN_CHECK_BATCH (phase 5's
     tolerances); `cli train --workload lrw1000` for two steps and a
     validation (launches per step of K3 and K4 as expected_launches counts
     them), `cli test` on its checkpoint (WER/PER equal to the in-memory
     model's), `lrw` for one step; finite losses and peak memory of the
     B=240 step;
  10. path D, `classify` at the full width, bf16, B=120, 31 frames: kernel
     path vs plain path for one step; `cli train --workload classify` for
     two steps and `cli test --workload classify` (word and language
     accuracy equal to the in-memory model's); finite losses and peak
     memory of the B=120 step; then the three-stage recipe at the full width and depth with
     one step per stage on seeded synthetic data: the frozen stages'
     frontend and encoder bit-identical, the transferred counts equal to the
     frontend and encoder parameters of the classify checkpoint;
  E1-E6. path E, the data-parallel, rematerialised training path
     (``sbl`` at the full width): E1 remat_frontend on vs off at
     B=TRAIN_CHECK_BATCH with PALLAS_BN=1, f32 and bf16 (phase 5's
     tolerances; the running statistics moved once; K7 launched once more
     per recomputed BatchNorm, as counted), then the bf16 B=240 step with
     remat on and off (finite losses, peak memory); E2 a step with grad_clip
     against optax's rule applied by hand to the unclipped gradients; E3
     the data-parallel step at W = 1 under NCCL against the plain step; E4
     W = 2 processes on the one card over gloo (``--dp-worker``), each with
     half of the B=240 batch, f32 (TF32 off), PALLAS_BN=1, remat on,
     dropout on, gold fed at every decode step (DP_USE_GOLD), against the
     one-process step on the whole batch, and with per-process
     BatchNorm the kept running statistics against local BatchNorm on
     process 0's half; E5 `cli train
     --mesh-data 1 --remat-frontend --profile-dir --tensorboard-dir`, two
     steps with PALLAS_INGEST=1 PALLAS_BN=1 (launches as counted: path E's
     column of the kernels line; the trace names K3's, K4's, K7's and K8's
     kernels; train/loss logged at each step, in metrics.jsonl or, where
     the tensorboard package is installed, its event file); E6
     convergence_check's
     default mode memorizes within MEMORIZE_STEPS;
  E7-E8. tensor parallelism (the mesh's model axis) on gloo grids of
     processes sharing the one card (``--tp-worker``; NCCL cannot put two
     ranks on one card, so NCCL with model > 1 waits for a machine with
     several): E7 the full-width ``sbl`` step at B=240 global (remat on,
     PALLAS_INGEST=1 PALLAS_BN=1, dropout on with its masks drawn, gold fed
     at every decode step) at model = 2 in f32 and bf16 and at data 2 x
     model 2 in f32, against the one-process step on the whole batch: loss,
     the gradients gathered over the model group (E4's comparison in f32,
     TP_BF16_TOL in bf16), the gathered parameters after the update (within
     2 lr) and the BN running statistics; K3/K4 launched on the local heads
     in every process; peak memory a process printed; E8 a Trainer on
     a (1, 2) grid (``sbl`` f32 at the full width, K11 on, B=E8_BATCH): two
     steps, a validation batch, a checkpoint written whole; the checkpoint
     loads at model = 1, whose greedy tokens equal the grid's decode (a
     difference only at a tie within TIE_TOL), and K11 ran on the gathered
     layer, 96 launches a decode;
  E9. the epoch-fused cached route (``cache_on_device``; the whole step
     one CUDA graph, replayed once a step) at the full ``sbl`` width,
     B=240, PALLAS_INGEST=1 PALLAS_BN=1, remat on, E9_CLIPS clips resident
     on the card: f32 (TF32 off, deterministic algorithms)
     E9_CHECK_STEPS steps graphed vs the
     per-step route (SBL_NO_EPOCH_FUSED=1; losses within E9_LOSS_RTOL, each
     parameter's update within E9_UPDATE_TOL, Adam's step counts equal),
     the per-step route's step 0 vs the host batch route's, the graph
     captured once and replayed once a step with the kernels' captured
     counts equal to expected_launches; bf16: each route in a fresh Trainer
     for two epochs, the graph's captured counts equal to
     expected_launches and the two routes' 12 losses bit for bit; one NCCL W = 1 graphed run (its collectives
     captured) against the run without a mesh; a checkpoint written on the
     CPU resumed on the card for two graphed steps against the CPU's own;
  F1-F3. the last slice's switches and host runtime: F1 FusedBNAct
     (``ops/bn_relu.py``) and DotBatchNorm (``ops/bn_dot.py``), forward and
     backward in bf16 at the five BatchNorm shapes of the B=240 step: their
     statistics against float64 sums (F1_STAT_TOL), each module against the
     port's BatchNorm (composed with the residual add and the ReLU for
     FusedBNAct) in y, dx, dscale, dbias, dres (F1_TOL) and the running
     statistics (F1_RUNNING_TOL), device times of each forward + backward;
     F2 the full-width ``sbl`` step (bf16, B=240, remat_frontend off,
     dropout 0, coins injected, the same weights and batch) with the
     switches off, PALLAS_BN=1, FUSED_BN_ACT=1, DOT_BN=1 and
     ``grad_accum_bf16``: loss and every gradient against the off step
     (F2_LOSS_TOL; FUSED_BN_ACT's and DOT_BN's gradients within
     F2_FLOOR_FACTOR times PALLAS_BN's distance, the noise floor of a
     BatchNorm whose statistics differ in their last bits, medians within
     F2_MEDIAN_TOL; grad_accum_bf16's loss bit for bit and its gradients
     within JAX's 0.05), K2/K3/K4 launched by each, and peak GB allocated
     and reserved over a step after a warm-up; then the graphed
     epoch-fused route at the tiny preset with grad_accum_bf16 and
     FUSED_BN_ACT, and with all three switches, against the per-step
     route (E9's loss tolerance); F3 the native runtime built with g++,
     ``levenshtein_native`` against the Python version on F3_PAIRS pairs,
     ``load_clip_batch`` against ``np.load`` on F3_CLIPS clips and its
     clips/s at 4 threads (the jpg dataset and its audio stream need
     OpenCV, which this machine lacks: CPU tests only); the launches of
     F2's five steps join the kernels line as five more paths;
  11. a JSON line of the eighteen kernels (each with its launches on every
     path, E7's and E8's among them, its error, its time, its plain version's, its bound on the card
     and a library call's time where one PyTorch call computes the same
     function), then the result line {"ok": true, "device": {...}}.

Every kernel time comes from CUDA events around each of TIMING_REPS
launches, each after a read of L2_FLUSH_BYTES (a cold L2, as the bounds'
HBM rate assumes), all queued behind a spin kernel so that the card runs
them back to back (the device time, not the wrappers' host time); every
bound is the larger of the bytes the function must move over HBM_BYTES_S
and its operations over the card's peak rate for their type (H100 SXM data
sheet: HBM3 3.35 TB/s, bf16 dense 989 TFLOP/s, f32 67 TFLOP/s outside the
tensor cores; 32-bit integer work, K5's, on INT32_OPS: 64 lanes a clock an
SM on each of the FMA and ALU pipes, for the instructions an element of
the function needs, K5_IMAD and K5_ALU).

Any failed phase raises, so the script exits non-zero without the result
line; so it does when torch sees no CUDA device, and when the port's
package is not beside it.

With --auto-avsr it runs instead phases 1, 2, 3f and 11a: first K12 and K1
against their plain versions, f32 and bf16 within K1_TOL, at the shapes
the auto_avsr_vsr path gives them (AVSR_KERNEL_BATCH utterances padded to
the longest and the shortest of AVSR_LENGTHS: K12 at (B, 12, T, 64) with
a rel-shifted positional term and MASK_FILL padded keys as its per-head
f32 bias, K1 as the beam's cross-attention, 40 query rows an utterance
over its T padded frames); then the preset (~250 M parameters, every
published width) through the normal path, ``build_model`` ->
``device_ingest`` with lengths -> the joint CTC/attention beam of
``decode.beam.make_ctc_attention_beam_decoder`` (beam 40, 32 steps), on
AVSR_BATCH utterances of AVSR_LENGTHS frames, in f32 (TF32 off) and in
bf16, with the longest and the shortest utterance judged by the
benchmark's own judge (``port_bench/core/judge_ctc.py``, against the
float32 reference on the card, each alone at its own length: CTC
log-probabilities, the decoder's logits at every step given the served
prefixes, the CTC prefix scores against the reference scorer on the
reference's and on the served log-probabilities, the frontier rule,
duplicates and order), f32 within AVSR_F32_TOL, bf16 within the cell's
limits (``port_bench/limits/auto_avsr_vsr.ctcbeam40.b64.json``); the
launches a batch (K2 1, K12 12, K1 6 x 32, K13 6 x 32 over the
hypotheses' slots 0..step).  Phase 11a also runs after F3 in the full run.

With --compare-eval it runs instead phase 3d (the eval-side kernels
K9-K11 against their plain versions, with their device times), with
--compare-bn phase 3c (K6-K8 against their plain versions, with their
device times), with --compare-ingest-mask phase 3b and
phase 3c's K6 rows (K3-K6 checked and timed: K5's and K6's times, K3's and
K4's beside them), in the checkout PARENT_DIR and in this one, in
turns (parent, change, change, parent), each in a process of its own with
that checkout first on sys.path and by that checkout's own chip_smoke.py,
so one card and one host serve both trees; each turn's lines go to
chiprun_out/compare_<set>_<label><turn>.log (set: eval, bn or
ingest_mask), and every turn's numbers with a summary (--compare-eval: the
K10/K11 times; --compare-bn: the K7/K8 times per shape and per bf16 step;
--compare-ingest-mask: K6's times per dtype and K5's, K3's and
K4's per train-step case with this tree's bounds, K5 queued back to back
and the launch floor split, both trees by this file's timers) and the
card's nvidia-smi name and power limit to chiprun_out/compare_<set>.json.
Whole paths (clips/s, ms/step, a batch's latency) are timed by the
benchmark, ``port_bench/run.py``, in pairs of runs on one card, and where a
call's time goes by ``python3 -m
sbl_for_multilingual_lip_reading_tpu_torch.profile_paths recognize|train``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# K1 against its plain version: f32 differs only in summation order; bf16
# outputs are rounded once from f32 on both sides, so they may sit one bf16
# ulp apart (2^-6 for |out| in [2, 4); |out| stays below 4 at these inputs)
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the slice at B=SLICE_CHECK_BATCH: kernel path vs plain path, same card,
# weights and clips.  f32 differs in summation order only.  In bf16 a K1 or
# stem flip of one ulp moves the LayerNorms after it, so whole logits move
# by a few ulps (one is 2^-5 for |logit| in [4, 8)).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
MIN_TOKEN_AGREEMENT = {"float32": 0.99, "bfloat16": 0.95}
TIMING_WARMUP = 3
TIMING_REPS = 20
# cycles the card's spin kernel runs per second: the H100 SXM's top SM clock
# (1.98 GHz), so a spin asked for s seconds lasts at least s
SPIN_CYCLES_PER_S = 1.98e9
# read before every timed call: twice the H100's 50 MB L2
L2_FLUSH_BYTES = 100 * 2 ** 20
SLICE_BATCH = 512
SLICE_CHECK_BATCH = 32
# the tiny preset's check on the card (phase 4b)
TINY_BATCH = 8
# training kernels against their plain versions on the same inputs and
# mask.  f32: summation order only (forward ~1e-6, gradients sum up to 30
# products of O(10) terms).  bf16: both round one f32 result, so they may
# sit one bf16 ulp apart (2^-7 relative), plus a floor at the tensor's scale
# for values near zero, where f32 noise exceeds an ulp.
TRAIN_TOL = {"float32": {"fwd": 1e-5, "grad": 1e-4},
             "bfloat16": {"rel": 2.0 ** -7, "floor": 2.0 ** -12}}
DROPOUT_RATE = 0.1
# K3/K4/K5 at the decoder's (480,17,512) / (480,8,17,17) in bf16 before their
# Philox counter took a head offset (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
H0_BEFORE_MS = {"fwd": 0.0282, "bwd": 0.0508, "mask": 0.0092}
KEEP_FRACTION = (0.895, 0.905)
# K5 off the train step's shapes (B, H, Tq, Tk), checked bit-exact: one
# element, n not a multiple of 16, one key, one head, one query row, and
# more runs of 16 than one wave of threads holds (the grid-stride loop)
MASK_SHAPES = ((1, 1, 1, 1), (3, 5, 7, 11), (4, 3, 5, 1), (7, 1, 9, 13), (2, 3, 1, 17),
               (960, 8, 31, 31))
# the train step's three mask shapes (B, H, Tq, Tk), K5's headline rows
MASK_TIMED = {"encoder (240,30,512)": (240, 8, 30, 30),
              "decoder self (480,17,512) causal": (480, 8, 17, 17),
              "cross (480,17)x(480,30)": (480, 8, 17, 30)}
TRAIN_BATCH = 240
TRAIN_CHECK_BATCH = 16
# a step's run on one resident batch: warm-up steps, then the steps whose
# losses must be finite and whose peak memory is read
TRAIN_WARMUP = 2
TRAIN_STEPS = 3
# one train step, kernel path vs plain path: same weights, batch and seeds,
# so the same masks.  f32 (TF32 off): attention sums in another order;
# bf16: one-ulp flips in K3/K4 move the LayerNorms after them.  Gradients
# compare per parameter as ||kernel - plain|| / ||plain||.
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.1}
TRAIN_BN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# K7/K8 against their plain versions: both form each term in f32 and sum
# in double, in another order, so each channel's result is its exact sum
# rounded once to f32 on both sides; the bound leaves room for a few f32
# roundings, relative to the sum of the magnitudes of its terms
STAT_TOL = 1e-5
BN_FRAMES = 7200            # B * T at B=240
# K6 off the train step's shape, checked bit-exact: (name, (B, T, raw,
# crop), clips' byte offset, output's element offset, the route expected)
INGEST_CASES = (("tiny preset 40 -> 32", (16, 30, 40, 32), 0, 0, "vector"),
                ("crop of no whole pieces", (16, 30, 96, 90), 0, 0, "scalar"),
                ("rows of no whole words", (16, 30, 94, 88), 0, 0, "scalar"),
                ("clips at an odd byte offset", (16, 30, 96, 88), 1, 0, "scalar"),
                ("output at an element offset", (16, 30, 96, 88), 0, 1, "scalar"))
# the frontend's BatchNorms at B=240: (name, (C, H, W), launches per step)
BN_SHAPES = (("stem", (64, 44, 44), 1), ("layer1", (64, 22, 22), 4),
             ("layer2", (128, 11, 11), 5), ("layer3", (256, 6, 6), 5),
             ("layer4", (512, 3, 3), 5))
# K7/K8 off the 16-byte route (checked, not on a path): rows that are no
# whole number of 16-byte pieces, and layer4's rows at an odd element
# offset; (name, (N, C, H, W), element offset)
BN_SCALAR_CASES = (("unaligned 45x45", (3, 1, 45, 45), 0),
                   ("unaligned 5x11x11", (480, 5, 11, 11), 0),
                   ("offset layer4", (480, 512, 3, 3), 1))
ENTRY_STEPS = 2
# path E: the data-parallel processes of the two-process check (on the one
# card, over gloo), the batch of the traced `cli train` run, and the step
# budget of convergence_check's default mode here: twice the tool's
# --steps default of 800, which the JAX tool itself misses at some seeds
# (on the CPU JAX memorized at 450-900 steps over six seeds, the port at
# 350-950 over five seeds and past 800 at three of five thread counts of
# one seed; on the card one run stood at one clip off at step 800)
DP_WORLD = 2
TRACE_BATCH = TRAIN_CHECK_BATCH
MEMORIZE_STEPS = 1600
# E9: E9_CLIPS SyntheticPatternDataset clips (0.40 GB of uint8, 24 a word)
# resident on the card, 6 steps an epoch at B=240; the f32 routes' losses
# agree to E9_LOSS_RTOL (with the deterministic algorithms below, bit for
# bit)
E9_CLIPS = 1440
E9_CHECK_STEPS = 3
E9_LOSS_RTOL = 1e-5
# the f32 routes' updates (parameters after minus before) agree per
# parameter to E3's gradient tolerance, with cuDNN's and torch's
# deterministic algorithms (``_deterministic``): with cuDNN's default ones
# two runs of the same route differ in the gradients' last bits, and a
# BatchNorm scale (near 1), which 3 steps of the warm-up's lr (3.5e-8 a
# step) move by 1-2 f32 ulps, took updates 5% apart.  E9_CHECK_STEPS from
# step 0, where the Noam lr grows as s + 1: a graph whose update was
# skipped, doubled or ran at an lr frozen at capture (1, 2, 2 for 1, 2, 3)
# moves the summed update by 1/6 or more
E9_UPDATE_TOL = TRAIN_GRAD_TOL["float32"]
# the resume check: a tiny sbl Trainer, dropout 0, E9_RESUME_BATCH a step
E9_RESUME_BATCH = 4
# K10 against its plain version.  f32: both sum K = 9C products in f32 in
# another order.  bf16: both round one f32 result, so outputs may sit one
# bf16 ulp apart (2^-7 relative); where the intermediate h flips one ulp in
# its own rounding, conv2 moves the output by a fraction of an ulp more:
# the floor, relative to the tensor's largest element.
RESBLOCK_TOL = {"float32": 1e-4, "bfloat16": {"rel": 2.0 ** -7, "floor": 2.0 ** -8}}
RESBLOCK_FRAMES = 15360      # B * T at B=512
RESBLOCK_F32_FRAMES = 1536
# (name, C, S, launches per recognize batch): ResNet-18's eligible blocks
RESBLOCK_SHAPES = (("layer1 x2", 64, 22, 2), ("layer2 block1", 128, 11, 1),
                   ("layer3 block1", 256, 6, 1), ("layer4 block1", 512, 3, 1))
# bf16 only, checked and not timed: channels whose weight rows TMA cannot
# map (9C bf16 not a multiple of 16 bytes), so the ring fills its stages
# through registers
RESBLOCK_REGISTER_SHAPES = (("weights through registers", 12, 8, 0),)
# K11 against its plain version: LayerNorm outputs of O(1).  f32: summation
# order (the FFN's w2 sum is taken in chunks).  bf16: seven roundings to
# bf16 inside the layer (q, k, v, two contexts, two LayerNorm outputs, the
# ReLU output) may each flip one ulp between the two, and the LayerNorms
# after them spread a flip over the row, so outputs move by a few bf16 ulps
# (one is 2^-7 for |out| in [1, 2)).
LAYER_TOL = {"float32": 2e-4, "bfloat16": 0.0625}
SWITCH_CHECK_BATCH = 16
SWITCH_LOGIT_TOL = 0.25      # bf16 first-step logits, switches on vs off
SWITCH_MIN_AGREEMENT = 0.98
UNI_BEAM = 5
CKPT_DIR = Path(__file__).resolve().parent / "checkpoints" / "chip_smoke"
# H100 SXM peaks (NVIDIA data sheet); the bounds below use them
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_OPS = 67e12
# 32-bit integer instructions a second on one pipe: compute capability 9.0
# runs 32-bit integer multiply (IMAD, on the FMA pipe) and add, logic,
# shift and compare (on the ALU pipe) each on 64 lanes a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput), so 64
# lanes x 132 SMs x the 1.98 GHz top SM clock = 16.7 T; NVIDIA's 33.5
# INT32 TOPS counts a multiply-add as two.  The two pipes run side by side,
# and a scheduler issues one warp instruction a clock (128 lanes an SM), so
# integer work takes at least max(IMAD, ALU, all / 2) / INT32_OPS.
INT32_OPS = 64 * 132 * 1.98e9
# The integer instructions an element of K5's function needs, whatever the
# kernel: word 0 of Philox4x32-10 at the element's counter.  A round is two
# 32 x 32 -> 64-bit products (IMAD.WIDE.U32 / IMAD.HI, the FMA pipe) and
# two three-way XORs (LOP3, the ALU pipe).  Working back from word 0 after
# round 10: round 10 needs one product's high half and one XOR (c0); round
# 9 both products and one XOR (c2); rounds 1-8 both of each.  19 IMAD and
# 18 LOP3.  The element adds three ALU instructions: the step of its
# counter j, the compare with the threshold and the predicated OR of its
# bit into the packed word.  The round keys depend on the seed alone, and
# the carries into i, h and b come once a row, so neither counts an
# element.  The kernel's own SASS (phase 2) is a diagnostic beside these.
K5_IMAD = 19
K5_ALU = 18 + 3
# K5's elements a thread (csrc/attention_train.cu kMaskRun), over which
# phase 2 counts its SASS per element
K5_RUN = 16
# launches back to back for queued_ms
FLOOR_QUEUE = 200
# F1: FusedBNAct / DotBatchNorm against the port's BatchNorm in bf16 at the
# B=240 step's BatchNorm shapes.  Their statistics are f32 sums of the same
# bf16 x in another order: within F1_STAT_TOL of the mean of |x| (and of
# x^2) of float64 sums, where a bf16 result of the products would be 2^-9
# off.  Outputs and gradients round f32 values that differ in their last
# bits to bf16, so a share of the elements sits one bf16 ulp apart: F1_TOL
# is one ulp (2^-7) as a relative L2 bound; the running statistics move by
# a tenth of the batch's, F1_RUNNING_TOL.
F1_STAT_TOL = 1e-5
F1_TOL = 2.0 ** -7
F1_RUNNING_TOL = 1e-5
# F2: the B=240 bf16 step with each switch against the switches off.  A
# BatchNorm whose statistics differ from the default's in their last f32
# bits flips bf16 roundings, ReLU routes and max-pool choices, and the
# frontend's gradients of this step move by up to a quarter of their norm
# (on an H100 at 700 W: K7/K8's exact sums 0.223, the default's means
# moved by 4e-6 0.292, DotBatchNorm 0.32; medians 0.002; in f32 at B=16
# 0.004, 0.022, 0.0045).  So FUSED_BN_ACT and DOT_BN are held to
# F2_FLOOR_FACTOR times the PALLAS_BN step's distance measured in the same
# run (or the kernel-vs-plain step's F2_GRAD_TOL), their medians to
# F2_MEDIAN_TOL; grad_accum_bf16 to JAX's 0.05 of its own test.  The
# graphed route at the tiny preset runs F2_FUSED_STEPS steps.
F2_LOSS_TOL = TRAIN_LOSS_TOL["bfloat16"]
F2_GRAD_TOL = TRAIN_GRAD_TOL["bfloat16"]
F2_FLOOR_FACTOR = 2.0
F2_MEDIAN_TOL = 0.01
F2_FUSED_STEPS = 3
# F3: random token pairs for levenshtein_native, clips for load_clip_batch
F3_PAIRS = 2000
F3_CLIPS = 64


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


_L2_FLUSH = []


def _l2_flush(torch):
    """A device buffer of L2_FLUSH_BYTES, made once; reading it evicts what
    the last call left in the card's L2 (reads leave clean lines, so the
    next call writes nothing back)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(L2_FLUSH_BYTES // 4, device="cuda"))
    return _L2_FLUSH[0]


def cuda_ms(torch, fn) -> float:
    """Device time of fn() in ms from a cold L2: CUDA events around each of
    TIMING_REPS calls, each after a read of L2_FLUSH_BYTES that evicts
    what the last call left in L2, averaged over the calls, after a
    warm-up.  Operands of some tens of MB would otherwise stay in the 50 MB
    L2 between calls and read faster than the HBM rate the bounds assume.
    The calls are queued behind a spin kernel (``torch.cuda._sleep``) that
    outlasts the host's time to queue them, so the card runs them back to
    back and the events see the card's time, not the wrappers' Python
    (which, at some 0.03 ms a call, is longer than a small kernel)."""
    flush = _l2_flush(torch)
    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        flush.sum()
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TIMING_REPS)]
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * host_s + 1e-3)))
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / TIMING_REPS


def bound(n_bytes: float, n_ops: float, ops_rate: float):
    """(least ms on the card, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / ops_rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


_SASS = {}


def sass_counts(pattern: str) -> dict:
    """{the groups of ``pattern`` in a kernel's mangled name: {pipe: static
    SASS instructions}} of the built library (``cuobjdump -sass``): "imad"
    (IMAD/IMUL, the FMA pipe's integer work), "alu" (the other integer,
    logic, compare and select instructions), "f32" (F* arithmetic), "issue"
    (every instruction but NOP, uniform-datapath U* and the trailing
    self-branch)."""
    import re
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
    if "text" not in _SASS:
        nvcc = _build.find_nvcc()
        check(nvcc is not None, "cuobjdump: no CUDA toolkit")
        res = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                              str(_build.library_path())], capture_output=True,
                             text=True, timeout=600, check=False)
        check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
        _SASS["text"] = res.stdout
    alu = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP",
           "SEL", "LEA", "IABS", "IMNMX", "VIMNMX", "FLO", "POPC", "BMSK", "SGXT",
           "PLOP3", "MOV", "BREV", "VIADD", "VIADDMNMX", "P2R", "R2P"}
    out, counts, last = {}, None, ""
    for line in _SASS["text"].splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            found = re.search(pattern, m.group(1))
            counts = None
            if found:
                counts = out.setdefault(found.groups(), dict(imad=0, alu=0, f32=0, issue=0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if counts is None or not m:
            continue
        op, after_exit = m.group(2).split(".")[0], last
        last = "EXIT" if op == "EXIT" and not m.group(1) else ""
        if op == "NOP" or op.startswith("U") or (op == "BRA" and after_exit):
            continue
        counts["issue"] += 1
        if op in ("IMAD", "IMUL"):
            counts["imad"] += 1
        elif op in alu:
            counts["alu"] += 1
        elif op.startswith("F") and op not in ("FENCE",):
            counts["f32"] += 1
    return out


def k5_sass_per_element() -> dict:
    """K5's static SASS counts per element, a diagnostic beside K5_IMAD and
    K5_ALU (its kernel's instructions over the K5_RUN elements a thread
    stores; the once-a-thread decomposition and the tail's stores
    included), and the pipe-limited integer instructions an element:
    max(IMAD, ALU, issue / 2)."""
    if "k5" not in _SASS:
        # the body without the batch-row map: the one the timed masks take
        found = sass_counts(r"dropout_keep_mask_kernelILb(\d)E")
        check(sorted(found) == [("0",), ("1",)],
              f"SASS of dropout_keep_mask_kernel: {sorted(found)}")
        per = {k: v / K5_RUN for k, v in found[("0",)].items()}
        per["pipe_limited"] = max(per["imad"], per["alu"], per["issue"] / 2)
        _SASS["k5"] = per
    return _SASS["k5"]


def k5_bound(n: int):
    """K5's bound over n elements: one byte written an element, and the
    function's pipe-limited integer instructions an element, max(K5_IMAD,
    K5_ALU, both / 2), over INT32_OPS."""
    per = max(K5_IMAD, K5_ALU, (K5_IMAD + K5_ALU) / 2)
    return bound(n, n * per, INT32_OPS)


def queued_ms(torch, fn, reps: int = FLOOR_QUEUE) -> float:
    """Device ms a call of fn() adds when ``reps`` calls run back to back:
    CUDA events around them all, queued behind a spin kernel, nothing read
    between them.  Beside cuda_ms's one call in a window, it leaves out what
    a launch costs when nothing runs before it."""
    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_floor(torch, dev) -> dict:
    """The smallest launch's time, split: "fill_ms", a one-element fill
    under cuda_ms (the flush, then events around the one launch);
    "empty_ms", the same window with no launch in it (the flush's tail and
    the events' own time); "queued_fill_ms", a fill's share of FLOOR_QUEUE
    fills back to back (what a launch costs the card with another queued
    behind it)."""
    one = torch.zeros(1, dtype=torch.uint8, device=dev)
    return dict(fill_ms=cuda_ms(torch, lambda: one.fill_(1)),
                empty_ms=cuda_ms(torch, lambda: None),
                queued_fill_ms=queued_ms(torch, lambda: one.fill_(1)))


def k5_queued_ms(torch, ops, dev, shape) -> float:
    """K5's queued_ms at a (B, H, Tq, Tk) mask."""
    B, H, Tq, Tk = shape
    seed = card_seed(torch, dev, 1000 + B * Tq + Tk)
    return queued_ms(torch, lambda: ops.dropout_keep_mask_flat(
        B, Tq, Tk, H, seed, DROPOUT_RATE, dev))


def card_seed(torch, dev, value: int):
    """A dropout seed as the train step gives it to K3/K4/K5: an int64 on
    the card, which the kernels read (their wrappers take no other)."""
    return torch.tensor(value, dtype=torch.int64, device=dev)


def library_time(torch, fn, call: str):
    """(CUDA-event ms of one PyTorch call, its description); (None, why)
    where the call refuses these inputs."""
    try:
        return cuda_ms(torch, fn), call
    except RuntimeError as e:
        return None, f"{call} (refused: {str(e).splitlines()[0][:120]})"


def sdpa_args(torch, q, k, v, H, bias):
    """q, k, v (B, T, H*d) as sdpa's (B, H, T, d) views, and the additive
    bias as its float mask."""
    def heads(t):
        return t.view(t.shape[0], t.shape[1], H, -1).transpose(1, 2)
    mask = None if bias is None else bias.to(q.dtype)[:, None]
    return heads(q), heads(k), heads(v), mask


def attention_bound(B, Tq, Tk, H, d, itemsize, bias, matmuls):
    """Bound of a flat attention: q and the output (B, Tq, H*d), k and v
    (B, Tk, H*d), the bias, and ``matmuls`` products of (Tq x Tk x d) per
    (row, head) in bf16."""
    n_bytes = (2 * B * Tq + 2 * B * Tk) * H * d * itemsize
    if bias is not None:
        n_bytes += bias.numel() * bias.element_size()
    return bound(n_bytes, matmuls * 2.0 * B * H * Tq * Tk * d, BF16_FLOPS)


def phase_card(torch):
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    smi = res.stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 card: torch device 0 = {name}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi, name


def phase_build():
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
    target = _build.library_path()
    cached = target.exists()
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"phase 2 build: {seconds:.2f} s ({'loaded' if cached else 'built'}"
          f" {target.name} with {' '.join(_build.NVCC_FLAGS)})")
    log = target.with_suffix(".log")
    if log.exists():
        text = log.read_text()
        for line in text.splitlines():
            if "Used" in line or ("spill" in line
                                  and "0 bytes spill stores, 0 bytes spill loads"
                                  not in line):
                print(f"  ptxas: {line.strip()}")
        spills = []
        # the attention bodies, one instantiation per head width: K1/K12's
        # and K3/K4's tensor-core bodies (bf16) and K3/K4's scalar ones (f32)
        for kernel, pattern, n in (
                ("small_mha_mma_kernel (K1/K12 bf16)",
                 r"small_mha_mma_kernelILi(\d+)E", 4),
                ("dropout_attention_fwd_mma_kernel (K3 bf16)",
                 r"dropout_attention_fwd_mma_kernelILi(\d+)E", 4),
                ("dropout_attention_bwd_mma_kernel (K4 bf16)",
                 r"dropout_attention_bwd_mma_kernelILi(\d+)ELb(\d)E", 8),
                ("dropout_attention_fwd_f32_kernel (K3 f32)",
                 r"dropout_attention_fwd_f32_kernelILi(\d+)E", 4),
                ("dropout_attention_bwd_f32_kernel (K4 f32)",
                 r"dropout_attention_bwd_f32_kernelILi(\d+)E", 4)):
            found = ptxas_report(text, pattern)
            check(len(found) == n, f"ptxas report of {kernel}: {sorted(found)}")
            for key, (used, spill) in sorted(found.items()):
                variant = {("1",): ", tiles", ("0",): ", recompute"}.get(key[1:], "")
                print(f"phase 2 {kernel} <d={key[0]}{variant}>: {used}; {spill}")
                if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                    spills.append(f"{kernel} <{key}>: {spill}")
        # the K10/K11 bodies: the tensor-core ones (bf16, csrc/gemm_ring.cuh)
        # and the f32 ones (gemm_tile.cuh's FMA tile)
        # (the K10 body once per number of 64-row tiles a warpgroup holds)
        for kernel, pattern, n, tensor_cores in (
                ("decoder_layer_mma_kernel (K11 bf16)", r"(decoder_layer_mma_kernel)", 1, True),
                ("resblock_mma_kernel (K10 bf16)", r"resblock_mma_kernelILi(\d+)E", 4, True),
                ("decoder_layer_kernel (K11 f32)", r"(decoder_layer_kernel)IfE", 1, False),
                ("resblock_kernel (K10 f32)", r"(resblock_kernel)IfE", 1, False)):
            found = ptxas_report(text, pattern)
            check(len(found) == n, f"ptxas report of {kernel}: {sorted(found)}")
            for key, (used, spill) in sorted(found.items()):
                variant = f" <{key[0]} x 64 rows>" if key[0].isdigit() else ""
                print(f"phase 2 {kernel}{variant}: {used}; {spill}")
                if tensor_cores and "0 bytes spill stores, 0 bytes spill loads" not in spill:
                    spills.append(f"{kernel}{variant}: {spill}")
        # K7/K8: one body per dtype, kernel and route (16-byte pieces, or
        # single elements)
        found = ptxas_report(text, r"channel_sums_kernelI(f|13__nv_bfloat16)Lb(\d)ELi(\d+)E")
        check(len(found) == 8, f"ptxas report of channel_sums_kernel: {sorted(found)}")
        for (dt, pair, epv), (used, spill) in sorted(found.items()):
            variant = (f"{'K8' if pair == '1' else 'K7'} {'f32' if dt == 'f' else 'bf16'}"
                       f" {'scalar' if epv == '1' else epv + '-element pieces'}")
            print(f"phase 2 channel_sums_kernel ({variant}): {used}; {spill}")
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                spills.append(f"channel_sums_kernel ({variant}): {spill}")
        # K5 (two bodies: without and with a data-parallel process's
        # batch-row map) and K6 (per dtype and route: pieces of 8 bf16 or 4
        # f32 outputs, or single outputs), with their static SASS counts
        found = ptxas_report(text, r"dropout_keep_mask_kernelILb(\d)E")
        check(sorted(found) == [("0",), ("1",)],
              f"ptxas report of dropout_keep_mask_kernel: {sorted(found)}")
        per = k5_sass_per_element()
        for (mapped,), (used, spill) in sorted(found.items()):
            extra = ("" if mapped == "1" else
                     f"; SASS an element (static, over {K5_RUN}): IMAD "
                     f"{per['imad']:.2f}, ALU {per['alu']:.2f}, issued "
                     f"{per['issue']:.2f}; pipe-limited {per['pipe_limited']:.2f}, "
                     f"against the function's IMAD {K5_IMAD}, ALU {K5_ALU}")
            print(f"phase 2 dropout_keep_mask_kernel (K5"
                  f"{', batch-row map' if mapped == '1' else ''}): {used}; {spill}{extra}")
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                spills.append(f"dropout_keep_mask_kernel<{mapped}>: {spill}")
        # K13: one body per dtype and head width
        found = ptxas_report(text, r"cached_attention_step_kernelI(f|13__nv_bfloat16)Li(\d+)E")
        check(len(found) == 8, f"ptxas report of cached_attention_step_kernel: {sorted(found)}")
        for (dt, width), (used, spill) in sorted(found.items()):
            variant = f"K13 {'f32' if dt == 'f' else 'bf16'} d={width}"
            print(f"phase 2 cached_attention_step_kernel ({variant}): {used}; {spill}")
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                spills.append(f"cached_attention_step_kernel ({variant}): {spill}")
        pattern = r"ingest_train_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E"
        found, sass = ptxas_report(text, pattern), sass_counts(pattern)
        check(len(found) == 4 and sorted(found) == sorted(sass),
              f"ptxas / SASS of ingest_train_kernel: {sorted(found)}, {sorted(sass)}")
        for (dt, epv, u), (used, spill) in sorted(found.items()):
            n = sass[(dt, epv, u)]
            outs = int(epv) * int(u)
            variant = (f"K6 {'f32' if dt == 'f' else 'bf16'} "
                       f"{'scalar' if epv == '1' else epv + '-output pieces'}, {u} a round")
            print(f"phase 2 ingest_train_kernel ({variant}): {used}; {spill}; SASS "
                  f"(static) {n['issue']} issued, {n['f32']} f32, {n['alu']} ALU, "
                  f"{n['imad']} IMAD: {n['issue'] / outs:.2f} issued an output of a round")
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                spills.append(f"ingest_train_kernel ({variant}): {spill}")
        check(not spills, f"kernels spill: {spills}")
    return seconds


def ptxas_report(text: str, pattern: str) -> dict:
    """{the groups of ``pattern`` in a kernel's mangled name: (its ptxas
    "Used ..." line, its spill line)} from nvcc's -Xptxas -v output."""
    import re
    out, key, spill = {}, None, ""
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            found = re.search(pattern, m.group(1))
            key = found.groups() if found else None
        elif key is not None and "spill" in line:
            spill = line.strip()
        elif key is not None and "Used" in line:
            out[key] = (line.split(":", 1)[-1].strip(), spill)
            key = None
    return out


def phase_kernels(torch, dev):
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"stack_frames": [], "small_mha_flat": []}

    # K2 at the stem's shape: B=512 clips of 30 frames of 88x88
    for dt in (torch.bfloat16, torch.float32):
        video = torch.randn((SLICE_BATCH, 30, 88, 88), generator=g,
                            device=dev, dtype=dt)
        got = ops.stack_frames(video)
        want = ops.stack_frames_plain(video)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 {dt} is not bit-exact")
        ms = cuda_ms(torch, lambda: ops.stack_frames(video))
        plain_ms = cuda_ms(torch, lambda: ops.stack_frames_plain(video))
        bound_ms, bound_by = bound(video.numel() * video.element_size() * 6, 0,
                                   F32_OPS)
        results["stack_frames"].append(dict(
            case="stem (512,30,88,88)", dtype=str(dt).split(".")[-1],
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            library_call="none: no single PyTorch call stacks shifted frames"))
        del video, got, want

    causal = ops.mask_to_bias(
        torch.ones(17, 17, dtype=torch.bool, device=dev).triu(1)[None], 17, 17)
    lengths = torch.randint(1, 18, (2 * SLICE_BATCH,), generator=g, device=dev)
    key_pad = ops.mask_to_bias(
        (torch.arange(17, device=dev)[None, :] >= lengths[:, None])[:, None],
        17, 17)
    masked_row = torch.zeros(1, 17, 17, device=dev)
    masked_row[0, 0] = ops.MASK_FILL
    long_pad = ops.mask_to_bias(
        torch.arange(150, device=dev)[None, None, :]
        >= torch.randint(1, 151, (64, 1, 1), generator=g, device=dev), 17, 150)
    cases = [  # (name, B, Tq, Tk, bias, d): the recognize path's shapes, H=8
        ("encoder (512,30,512)", SLICE_BATCH, 30, 30, None, 64),
        ("decoder self (1024,17,512) causal", 2 * SLICE_BATCH, 17, 17, causal, 64),
        ("cross (1024,17)x(1024,30)", 2 * SLICE_BATCH, 17, 30, None, 64),
        # the unidirectional cached decode: one query token per step
        ("cached cross (512,1)x(512,30)", SLICE_BATCH, 1, 30, None, 64),
        ("per-batch bias (1024,17,17)", 2 * SLICE_BATCH, 17, 17, key_pad, 64),
        ("masked row", 2 * SLICE_BATCH, 17, 17, masked_row, 64),
        # off the path: the multi-tile key loop (any Tk)
        ("extra: Tk=150", 64, 17, 150, None, 64),
        ("extra: Tk=150 per-batch bias", 64, 17, 150, long_pad, 64),
        # the other head widths the kernel is built for (cli --d_model /
        # --n_head; the tiny presets' d_k = 16), at the encoder's and the
        # decoder's shapes
        ("d=16 encoder (512,30,8x16)", SLICE_BATCH, 30, 30, None, 16),
        ("d=16 decoder self (1024,17,8x16) causal", 2 * SLICE_BATCH, 17, 17,
         causal, 16),
        ("d=32 encoder (512,30,8x32)", SLICE_BATCH, 30, 30, None, 32),
        ("d=32 cached cross (512,1)x(512,30)", SLICE_BATCH, 1, 30, None, 32),
        ("d=128 encoder (512,30,8x128)", SLICE_BATCH, 30, 30, None, 128),
        ("d=128 decoder self (1024,17,8x128) causal", 2 * SLICE_BATCH, 17, 17,
         causal, 128),
        ("extra: d=128 Tk=150 per-batch bias", 64, 17, 150, long_pad, 128),
        ("extra: d=16 Tq=Tk=70", 64, 70, 70, None, 16),
    ]
    H = 8
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        for name, B, Tq, Tk, bias, d in cases:
            q = torch.randn((B, Tq, H * d), generator=g, device=dev, dtype=dt)
            k = torch.randn((B, Tk, H * d), generator=g, device=dev, dtype=dt)
            v = torch.randn((B, Tk, H * d), generator=g, device=dev, dtype=dt)
            got = ops.small_mha_flat(q, k, v, H, bias=bias)
            want = ops.small_mha_flat_plain(q, k, v, H, bias=bias)
            err = (got.float() - want.float()).abs().max().item()
            check(err <= K1_TOL[name_dt] and torch.isfinite(got).all().item(),
                  f"K1 {name} {name_dt}: max abs err {err} > {K1_TOL[name_dt]}")
            ms = cuda_ms(torch, lambda: ops.small_mha_flat(q, k, v, H, bias=bias))
            plain_ms = cuda_ms(torch, lambda: ops.small_mha_flat_plain(
                q, k, v, H, bias=bias))
            sq, sk, sv, mask = sdpa_args(torch, q, k, v, H, bias)
            lib_ms, lib_call = library_time(
                torch, lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask),
                "F.scaled_dot_product_attention on (B,H,T,d) views")
            bound_ms, bound_by = attention_bound(B, Tq, Tk, H, d,
                                                 q.element_size(), bias, 2)
            results["small_mha_flat"].append(dict(
                case=name, dtype=name_dt, d=d, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, library_call=lib_call))
    for kernel, rows in results.items():
        for r in rows:
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            print(f"phase 3 {kernel} {r['case']} {r['dtype']}: max abs err "
                  f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {lib}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def _bf16_close(got, want):
    """Max abs error and whether every element is within one bf16 ulp of
    the plain value (2^-7 relative) plus the floor of TRAIN_TOL."""
    tol = TRAIN_TOL["bfloat16"]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = want.abs() * tol["rel"] + want.abs().max() * tol["floor"]
    return err.max().item(), bool((err <= limit).all())


def _train_close(got, want, kind):
    """(max abs error, within TRAIN_TOL): f32 absolute at the tensor's
    scale (``kind`` "fwd" or "grad"), bf16 in ulps."""
    if dtype_name(want) == "float32":
        err = (got - want).abs().max().item()
        tol = TRAIN_TOL["float32"][kind] * max(1.0, want.abs().max().item())
        return err, err <= tol
    return _bf16_close(got, want)


def _ms(x):
    return "n/a" if x is None else f"{x:.4f}"


def dtype_name(t):
    return str(t.dtype).split(".")[-1]


def phase_train_kernels(torch, dev, timing=True):
    """K3/K4/K5 against their plain versions at the train step's shapes
    (``timing`` False: the checks alone, every time NaN)."""
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(1)

    def ms_of(fn):
        return cuda_ms(torch, fn) if timing else float("nan")

    def lib_of(fn, call):
        return library_time(torch, fn, call) if timing else (None, call)
    H, B = 8, TRAIN_BATCH
    L = 17
    causal = ops.mask_to_bias(
        torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)[None], L, L)
    beyond = ops.mask_to_bias(
        (torch.arange(3, device=dev) > 1)[None, None, :], 3, 3)
    masked_row = torch.zeros(1, L, L, device=dev)
    masked_row[0, 0] = ops.MASK_FILL
    cases = [  # (name, rows, Tq, Tk, bias): the train step's shapes, H=8
        ("encoder (240,30,512)", B, 30, 30, None),
        ("decoder self (480,17,512) causal", 2 * B, L, L, causal),
        ("decoder self (480,3,512) prefix", 2 * B, 3, 3, beyond),
        ("cross (480,17)x(480,30)", 2 * B, L, 30, None),
        ("masked row (480,17,512)", 2 * B, L, L, masked_row),
    ]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        for case, N, Tq, Tk, bias in cases:
            seed = card_seed(torch, dev, 1000 + N * Tq + Tk)
            q = torch.randn((N, Tq, H * 64), generator=g, device=dev, dtype=dt)
            k = torch.randn((N, Tk, H * 64), generator=g, device=dev, dtype=dt)
            v = torch.randn((N, Tk, H * 64), generator=g, device=dev, dtype=dt)
            dout = torch.randn((N, Tq, H * 64), generator=g, device=dev, dtype=dt)
            keep = ops.dropout_keep_mask_flat(N, Tq, Tk, H, seed, DROPOUT_RATE, dev)
            plain_keep = ops.dropout_keep_mask_flat_plain(N, Tq, Tk, H, seed,
                                                          DROPOUT_RATE, dev)
            torch.cuda.synchronize()
            check(torch.equal(keep, plain_keep), f"K5 {case}: mask differs "
                  "from the plain Philox")
            frac = keep.float().mean().item()
            if Tq * Tk >= 289:
                check(KEEP_FRACTION[0] <= frac <= KEEP_FRACTION[1],
                      f"K5 {case}: keep fraction {frac}")
            args = (q, k, v, H, bias, seed, DROPOUT_RATE, None)
            got = ops.small_mha_dropout_fwd_flat(*args)
            want = ops.small_mha_dropout_flat_plain(*args, keep=plain_keep)
            fwd_err, ok = _train_close(got, want, "fwd")
            check(ok and bool(torch.isfinite(got).all()),
                  f"K3 {case} {name_dt}: max abs err {fwd_err}")
            got0 = ops.small_mha_dropout_fwd_flat(q, k, v, H, bias, 0, 0.0)
            want0 = ops.small_mha_flat(q, k, v, H, bias=bias)
            k1_err, ok = _train_close(got0, want0, "fwd")
            check(ok, f"K3 at rate 0 vs K1 {case} {name_dt}: {k1_err}")
            grads = ops.small_mha_dropout_bwd_flat(*args, dout)
            wants = ops.small_mha_dropout_bwd_flat_plain(*args, dout,
                                                         keep=plain_keep)
            bwd_err = 0.0
            for which, a, b in zip("qkv", grads, wants):
                err, ok = _train_close(a, b, "grad")
                check(ok and bool(torch.isfinite(a).all()),
                      f"K4 {case} {name_dt} d{which}: max abs err {err}")
                bwd_err = max(bwd_err, err)
            sq, sk, sv, mask = sdpa_args(torch, q, k, v, H, bias)
            fwd_lib_ms, fwd_lib_call = lib_of(
                lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask, dropout_p=DROPOUT_RATE),
                "F.scaled_dot_product_attention(dropout_p=0.1) on (B,H,T,64) views")
            gq, gk, gv = (t.detach().requires_grad_(True) for t in (sq, sk, sv))
            lib_out = F.scaled_dot_product_attention(gq, gk, gv, attn_mask=mask,
                                                     dropout_p=DROPOUT_RATE)
            lib_dout = dout.view(N, Tq, H, 64).transpose(1, 2)
            bwd_lib_ms, bwd_lib_call = lib_of(
                lambda: torch.autograd.grad(lib_out, (gq, gk, gv), lib_dout,
                                                   retain_graph=True),
                "the backward of F.scaled_dot_product_attention(dropout_p=0.1)")
            del lib_out, gq, gk, gv
            itemsize = q.element_size()
            fwd_bound = attention_bound(N, Tq, Tk, H, 64, itemsize, bias, 2)
            # K4 reads dout besides q, k, v, bias and writes dq, dk, dv: one
            # more q-sized read and the k, v-sized writes; five products
            bwd_bound = bound(
                attention_bound(N, Tq, Tk, H, 64, itemsize, bias, 0)[0]
                * HBM_BYTES_S / 1e3 + (N * Tq + 2 * N * Tk) * H * 64 * itemsize,
                5 * 2.0 * N * H * Tq * Tk * 64, BF16_FLOPS)
            # K5 writes one byte per score and draws one Philox4x32-10
            # word (K5_IMAD, K5_ALU)
            mask_bound = k5_bound(N * H * Tq * Tk)
            rows.append(dict(
                fwd_bound=fwd_bound, bwd_bound=bwd_bound, mask_bound=mask_bound,
                fwd_lib_ms=fwd_lib_ms, fwd_lib_call=fwd_lib_call,
                bwd_lib_ms=bwd_lib_ms, bwd_lib_call=bwd_lib_call,
                case=case, dtype=name_dt, keep_fraction=frac,
                fwd_err=fwd_err, bwd_err=bwd_err, rate0_vs_k1_err=k1_err,
                fwd_ms=ms_of(lambda: ops.small_mha_dropout_fwd_flat(*args)),
                fwd_plain_ms=ms_of(lambda: ops.small_mha_dropout_flat_plain(*args)),
                bwd_ms=ms_of(lambda: ops.small_mha_dropout_bwd_flat(*args, dout)),
                bwd_plain_ms=ms_of(lambda: ops.small_mha_dropout_bwd_flat_plain(
                    *args, dout)),
                mask_ms=ms_of(lambda: ops.dropout_keep_mask_flat(
                    N, Tq, Tk, H, seed, DROPOUT_RATE, dev)),
                mask_plain_ms=ms_of(lambda: ops.dropout_keep_mask_flat_plain(
                    N, Tq, Tk, H, seed, DROPOUT_RATE, dev))))
    for r in rows:
        print(f"phase 3b {r['case']} {r['dtype']}: keep {r['keep_fraction']:.4f}; "
              f"K3 err {r['fwd_err']:.3g}, {r['fwd_ms']:.4f} ms (plain "
              f"{r['fwd_plain_ms']:.4f}, sdpa {_ms(r['fwd_lib_ms'])}, bound "
              f"{r['fwd_bound'][0]:.4f}); K4 err {r['bwd_err']:.3g}, "
              f"{r['bwd_ms']:.4f} ms (plain {r['bwd_plain_ms']:.4f}, sdpa "
              f"{_ms(r['bwd_lib_ms'])}, bound {r['bwd_bound'][0]:.4f}); K5 "
              f"bit-exact, {r['mask_ms']:.4f} ms (plain {r['mask_plain_ms']:.4f}, "
              f"bound {r['mask_bound'][0]:.4f}); "
              f"K3 rate 0 vs K1 err {r['rate0_vs_k1_err']:.3g}")

    # K5 off the train step's shapes, bit-exact against the plain Philox;
    # at the train step's, its time queued back to back and the launch
    # floor, split, beside its times and bounds
    for B_, H_, Tq_, Tk_ in MASK_SHAPES:
        seed = card_seed(torch, dev, 3000 + B_ * H_ + Tq_ * Tk_)
        keep = ops.dropout_keep_mask_flat(B_, Tq_, Tk_, H_, seed, DROPOUT_RATE, dev)
        check(torch.equal(keep, ops.dropout_keep_mask_flat_plain(
            B_, Tq_, Tk_, H_, seed, DROPOUT_RATE, dev)),
            f"K5 ({B_},{H_},{Tq_},{Tk_}): mask differs from the plain Philox")
    # the batch-row map of process 1 of 2 of a data-parallel step (its rows
    # of the whole batch's masks; the decoder's two directions in one
    # launch): K5 bit-exact against the plain Philox and against those rows
    # of the one-process mask, and K3/K4 against their plain versions given
    # that mask
    half = TRAIN_BATCH // 2
    rows_map = ops.BatchRows(half, half, TRAIN_BATCH)
    seed = card_seed(torch, dev, 4242)
    whole = ops.dropout_keep_mask_flat(2 * TRAIN_BATCH, L, L, H, seed,
                                       DROPOUT_RATE, dev)
    mine = ops.dropout_keep_mask_flat(2 * half, L, L, H, seed, DROPOUT_RATE, dev,
                                      rows_map)
    check(torch.equal(mine, ops.dropout_keep_mask_flat_plain(
        2 * half, L, L, H, seed, DROPOUT_RATE, dev, rows_map)),
        "K5 with a batch-row map differs from the plain Philox")
    check(torch.equal(mine, torch.cat([whole[half:TRAIN_BATCH],
                                       whole[TRAIN_BATCH + half:]])),
          "K5 with a batch-row map is not its rows of the one-process mask")
    map_errs = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn((2 * half, L, H * 64), generator=g, device=dev,
                                     dtype=dt) for _ in range(4))
        args = (q, k, v, H, causal, seed, DROPOUT_RATE, None)
        got = ops.small_mha_dropout_fwd_flat(*args, rows=rows_map)
        err, ok = _train_close(got, ops.small_mha_dropout_flat_plain(
            *args, keep=mine), "fwd")
        check(ok, f"K3 with a batch-row map {dt}: {err}")
        map_errs.append(err)
        for which, a, b in zip("qkv", ops.small_mha_dropout_bwd_flat(
                *args, dout, rows=rows_map), ops.small_mha_dropout_bwd_flat_plain(
                *args, dout, keep=mine)):
            err, ok = _train_close(a, b, "grad")
            check(ok, f"K4 with a batch-row map {dt} d{which}: {err}")
            map_errs.append(err)
    print(f"phase 3b batch-row map {tuple(rows_map)} at ({2 * half},{L},{L}): K5 "
          f"bit-exact, its rows of the one-process mask; K3/K4 max err "
          f"{max(map_errs):.3g}")
    # the head map of model process 1 of 2 of a tensor-parallel step (heads
    # 4-7 of 8, h0 = 4) with the batch-row map above: K5 bit-exact against
    # the plain Philox and equal to those heads (and rows) of the
    # one-process mask; K3/K4 within TRAIN_TOL of their plain versions given
    # that mask, and equal to those heads' columns of the one-process
    # launch's outputs (a block per (row, head) computes the same values
    # whatever the launch's other heads)
    h0, Hl = H // 2, H // 2
    heads = slice(h0 * 64, (h0 + Hl) * 64)
    local_mask = ops.dropout_keep_mask_flat(2 * half, L, L, Hl, seed, DROPOUT_RATE,
                                            dev, rows_map, h0)
    check(torch.equal(local_mask, ops.dropout_keep_mask_flat_plain(
        2 * half, L, L, Hl, seed, DROPOUT_RATE, dev, rows_map, h0)),
        "K5 with a head map differs from the plain Philox")
    check(torch.equal(local_mask, mine[:, h0:h0 + Hl]),
          "K5 with a head map is not its heads of the one-process mask")
    head_errs = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn((2 * half, L, H * 64), generator=g, device=dev,
                                     dtype=dt) for _ in range(4))
        args = (q, k, v, H, causal, seed, DROPOUT_RATE, None)
        part = [t[..., heads].contiguous() for t in (q, k, v, dout)]
        largs = (*part[:3], Hl, causal, seed, DROPOUT_RATE, None)
        got = ops.small_mha_dropout_fwd_flat(*largs, rows=rows_map, h0=h0)
        err, ok = _train_close(got, ops.small_mha_dropout_flat_plain(
            *largs, keep=local_mask), "fwd")
        check(ok, f"K3 with a head map {dt}: {err}")
        head_errs.append(err)
        check(torch.equal(got, ops.small_mha_dropout_fwd_flat(
            *args, rows=rows_map)[..., heads]),
            f"K3 with a head map {dt}: not its heads of the one-process launch")
        whole_grads = ops.small_mha_dropout_bwd_flat(*args, dout, rows=rows_map)
        for which, a, b, w in zip("qkv", ops.small_mha_dropout_bwd_flat(
                *largs, part[3], rows=rows_map, h0=h0),
                ops.small_mha_dropout_bwd_flat_plain(
                    *largs, part[3], keep=local_mask), whole_grads):
            err, ok = _train_close(a, b, "grad")
            check(ok, f"K4 with a head map {dt} d{which}: {err}")
            check(torch.equal(a, w[..., heads]), f"K4 with a head map {dt} "
                  f"d{which}: not its heads of the one-process launch")
            head_errs.append(err)
    print(f"phase 3b head map h0 = {h0} ({Hl} of {H} heads) with the batch-row "
          f"map at ({2 * half},{L},{Hl}x64): K5 bit-exact, its heads of the "
          f"one-process mask; K3/K4 max err {max(head_errs):.3g}, each its heads "
          f"of the one-process launch, bit for bit")
    floor = (launch_floor(torch, dev) if timing
             else dict(fill_ms=float("nan"), empty_ms=float("nan"),
                       queued_fill_ms=float("nan")))
    print(f"phase 3b launch floor: a one-element fill {floor['fill_ms']:.4f} ms, "
          f"the same window with no launch {floor['empty_ms']:.4f}, a fill queued "
          f"behind another {floor['queued_fill_ms']:.4f}")
    for r in rows:
        r["launch_floor"] = floor
        if r["dtype"] == "bfloat16" and r["case"] in MASK_TIMED:
            r["mask_queued_ms"] = (k5_queued_ms(torch, ops, dev, MASK_TIMED[r["case"]])
                                   if timing else float("nan"))
            share = r["mask_bound"][0] / r["mask_ms"]
            print(f"phase 3b K5 {r['case']}: {r['mask_ms']:.4f} ms ({share:.0%} of "
                  f"its bound {r['mask_bound'][0]:.5f}, {r['mask_bound'][1]}), "
                  f"{r['mask_ms'] - floor['fill_ms']:.4f} above the fill; queued "
                  f"{r['mask_queued_ms']:.4f} ms "
                  f"({r['mask_bound'][0] / r['mask_queued_ms']:.0%} of its bound)")
    print(f"phase 3b K5 bit-exact at {', '.join(str(s) for s in MASK_SHAPES)}")
    dec = next(r for r in rows if r["dtype"] == "bfloat16"
               and r["case"] == "decoder self (480,17,512) causal")
    print(f"phase 3b at h0 = 0, decoder self (480,17,512) causal bf16 (a record, "
          f"beside the tree before the head offset: K3 {H0_BEFORE_MS['fwd']}, K4 "
          f"{H0_BEFORE_MS['bwd']}, K5 {H0_BEFORE_MS['mask']} ms): K3 "
          f"{dec['fwd_ms']:.4f}, K4 {dec['bwd_ms']:.4f}, K5 {dec['mask_ms']:.4f} ms")

    # the other head widths K3/K4 are built for (the tiny presets' d_k = 16;
    # cli --d_model / --n_head), at the train step's shapes, and lengths
    # past one tile of 32 keys, up to the shared memory's edge at d = 128
    long_causal = ops.mask_to_bias(
        torch.ones(70, 70, dtype=torch.bool, device=dev).triu(1)[None], 70, 70)
    long_pad = ops.mask_to_bias(
        torch.arange(150, device=dev)[None, None, :]
        >= torch.randint(1, 151, (64, 1, 1), generator=g, device=dev), 17, 150)
    edge_causal = ops.mask_to_bias(
        torch.ones(116, 116, dtype=torch.bool, device=dev).triu(1)[None], 116, 116)
    wide_pad = ops.mask_to_bias(
        torch.arange(300, device=dev)[None, None, :]
        >= torch.randint(1, 301, (64, 1, 1), generator=g, device=dev), 1, 300)
    extras = [  # (name, rows, Tq, Tk, bias, d), H=8
        ("d=16 encoder (240,30,8x16)", B, 30, 30, None, 16),
        ("d=16 decoder self (480,17,8x16) causal", 2 * B, L, L, causal, 16),
        ("d=32 cross (480,17)x(480,30)", 2 * B, L, 30, None, 32),
        ("d=128 encoder (240,30,8x128)", B, 30, 30, None, 128),
        ("d=128 decoder self (480,17,8x128) causal", 2 * B, L, L, causal, 128),
        ("extra: d=64 Tq=Tk=70 causal", 64, 70, 70, long_causal, 64),
        ("extra: d=16 Tq=17 Tk=150 per-batch bias", 64, L, 150, long_pad, 16),
        ("extra: d=128 Tq=Tk=84 (shared memory's edge)", 32, 84, 84, None, 128),
        # the longest equal lengths the other widths take (train_kernels_fit),
        # and one query row against many keys (K4's key tiles in three sweeps)
        ("extra: d=16 Tq=Tk=153 (shared memory's edge)", 32, 153, 153, None, 16),
        ("extra: d=32 Tq=Tk=139 (shared memory's edge)", 32, 139, 139, None, 32),
        ("extra: d=64 Tq=Tk=116 causal (shared memory's edge)", 32, 116, 116,
         edge_causal, 64),
        ("extra: d=64 Tq=1 Tk=300 per-batch bias", 64, 1, 300, wide_pad, 64),
    ]
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        for case, N, Tq, Tk, bias, d in extras:
            seed = card_seed(torch, dev, 2000 + N * Tq + Tk + d)
            q = torch.randn((N, Tq, H * d), generator=g, device=dev, dtype=dt)
            k = torch.randn((N, Tk, H * d), generator=g, device=dev, dtype=dt)
            v = torch.randn((N, Tk, H * d), generator=g, device=dev, dtype=dt)
            dout = torch.randn((N, Tq, H * d), generator=g, device=dev, dtype=dt)
            keep = ops.dropout_keep_mask_flat_plain(N, Tq, Tk, H, seed,
                                                    DROPOUT_RATE, dev)
            args = (q, k, v, H, bias, seed, DROPOUT_RATE, None)
            fwd_err, ok = _train_close(ops.small_mha_dropout_fwd_flat(*args),
                                       ops.small_mha_dropout_flat_plain(*args, keep=keep),
                                       "fwd")
            check(ok, f"K3 {case} {name_dt}: max abs err {fwd_err}")
            bwd_err = 0.0
            for which, a, b in zip("qkv", ops.small_mha_dropout_bwd_flat(*args, dout),
                                   ops.small_mha_dropout_bwd_flat_plain(
                                       *args, dout, keep=keep)):
                err, ok = _train_close(a, b, "grad")
                check(ok and bool(torch.isfinite(a).all()),
                      f"K4 {case} {name_dt} d{which}: max abs err {err}")
                bwd_err = max(bwd_err, err)
            itemsize = q.element_size()
            fwd_bound = attention_bound(N, Tq, Tk, H, d, itemsize, bias, 2)[0]
            bwd_bound = bound(
                attention_bound(N, Tq, Tk, H, d, itemsize, bias, 0)[0]
                * HBM_BYTES_S / 1e3 + (N * Tq + 2 * N * Tk) * H * d * itemsize,
                5 * 2.0 * N * H * Tq * Tk * d, BF16_FLOPS)[0]
            fwd_ms = ms_of(lambda: ops.small_mha_dropout_fwd_flat(*args))
            fwd_plain = ms_of(lambda: ops.small_mha_dropout_flat_plain(*args))
            bwd_ms = ms_of(lambda: ops.small_mha_dropout_bwd_flat(*args, dout))
            bwd_plain = ms_of(lambda: ops.small_mha_dropout_bwd_flat_plain(
                *args, dout))
            print(f"phase 3b {case} {name_dt}: K3 err {fwd_err:.3g}, {fwd_ms:.4f} ms "
                  f"(plain {fwd_plain:.4f}, bound {fwd_bound:.4f}); K4 err "
                  f"{bwd_err:.3g}, {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, bound "
                  f"{bwd_bound:.4f})")

    # max-pool tie gradients: the card's backward against the CPU's on a
    # post-ReLU bf16 input of small integers, full of ties (zeros and equal
    # values), with integer output gradients, so that every sum of them is
    # exact and only where each window's gradient goes is compared
    x = torch.randint(-6, 6, (32, 64, 44, 44), generator=g, device=dev)
    x = torch.relu(x).to(torch.bfloat16)
    dy = torch.randint(-8, 8, (32, 64, 22, 22), generator=g, device=dev
                       ).to(torch.bfloat16)
    grads = []
    for d in (dev, torch.device("cpu")):
        xi = x.to(d, copy=True).requires_grad_(True)
        F.max_pool2d(xi, 3, 2, 1).backward(dy.to(d))
        grads.append(xi.grad.cpu())
    ties = (x == 0).float().mean().item()
    check(torch.equal(*grads), "max-pool tie gradients differ card vs CPU")
    print(f"phase 3b max pool (32,64,44,44) bf16, {ties:.2f} zeros: card "
          f"backward routes every tie as the CPU's does")
    return rows


def phase_twin_kernels(torch, dev, timing=True):
    """The (B, T, H, d) twins (the flat kernels on views) and K12 fused_mha
    against their plain versions and against the flat kernels; times of
    kernel, plain version and scaled_dot_product_attention; bounds."""
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(12)
    H, d = 8, 64
    rows = {k: [] for k in ("fused_small_mha", "small_mha_bwd",
                            "small_mha_dropout_fwd", "small_mha_dropout_bwd",
                            "dropout_keep_mask", "fused_mha")}

    def ms_of(fn):
        return cuda_ms(torch, fn) if timing else float("nan")

    def causal_bias(T):
        return ops.mask_to_bias(
            torch.ones(T, T, dtype=torch.bool, device=dev).triu(1)[None], T, T)

    def headed(B, T, dt):
        return torch.randn((B, T, H, d), generator=g, device=dev, dtype=dt)

    def flat(t):
        return t.view(t.shape[0], t.shape[1], -1)

    def sdpa_views(t):       # (B, T, H, d) -> sdpa's (B, H, T, d) view
        return t.transpose(1, 2)

    def add(kernel, case, name_dt, err, ms, plain_ms, bound_, lib, **extra):
        rows[kernel].append(dict(
            case=case, dtype=name_dt, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_[0], bound_by=bound_[1], library_ms=lib[0],
            library_call=lib[1], **extra))

    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        item = torch.tensor([], dtype=dt).element_size()
        # ---- fused_small_mha: K1 on the view, at the decoder's shape
        B, T = 2 * SLICE_BATCH, 17
        bias = causal_bias(T)
        q, k, v = (headed(B, T, dt) for _ in range(3))
        got = ops.fused_small_mha(q, k, v, bias)
        flat_out = ops.small_mha_flat(flat(q), flat(k), flat(v), H, bias=bias)
        want = ops.fused_small_mha_plain(q, k, v, bias)
        torch.cuda.synchronize()
        check(torch.equal(flat(got), flat_out),
              f"fused_small_mha {name_dt}: not bit-identical to K1 on the view")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= K1_TOL[name_dt], f"fused_small_mha {name_dt}: {err}")
        mask = bias.to(dt)[:, None]
        add("fused_small_mha", f"({B},{T},{H},{d}) causal", name_dt, err,
            ms_of(lambda: ops.fused_small_mha(q, k, v, bias)),
            ms_of(lambda: ops.fused_small_mha_plain(q, k, v, bias)),
            attention_bound(B, T, T, H, d, item, bias, 2),
            library_time(torch, lambda: F.scaled_dot_product_attention(
                sdpa_views(q), sdpa_views(k), sdpa_views(v), attn_mask=mask),
                "F.scaled_dot_product_attention on (B,H,T,64) views")
            if timing else (None, "not timed"))
        del q, k, v, got, flat_out, want

        # ---- small_mha: K1 forward, K4 at rate 0 backward, the train shape
        B = 2 * TRAIN_BATCH
        q, k, v, dout = (headed(B, T, dt) for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.small_mha(*leaves, bias).backward(dout)
        wants = ops.small_mha_bwd_plain(q, k, v, bias, None, dout)
        bwd = ops.small_mha_bwd(q, k, v, bias, None, dout)
        flat_bwd = ops.small_mha_dropout_bwd_flat(
            flat(q), flat(k), flat(v), H, bias, 0, 0.0, None, flat(dout))
        torch.cuda.synchronize()
        err = 0.0
        for which, leaf, a, b, c in zip("qkv", leaves, bwd, wants, flat_bwd):
            check(torch.equal(leaf.grad, a) and torch.equal(flat(a), c),
                  f"small_mha d{which} {name_dt}: not K4 at rate 0 on the view")
            e, ok = _train_close(a, b, "grad")
            check(ok and bool(torch.isfinite(a).all()),
                  f"small_mha d{which} {name_dt}: max abs err {e}")
            err = max(err, e)
        lib = (None, "not timed")
        if timing:
            gq, gk, gv = (sdpa_views(t).detach().requires_grad_(True)
                          for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(gq, gk, gv, attn_mask=mask)
            lib = library_time(torch, lambda: torch.autograd.grad(
                lib_out, (gq, gk, gv), sdpa_views(dout), retain_graph=True),
                "the backward of F.scaled_dot_product_attention")
        bwd_bound = bound(
            attention_bound(B, T, T, H, d, item, bias, 0)[0] * HBM_BYTES_S / 1e3
            + 3 * B * T * H * d * item, 5 * 2.0 * B * H * T * T * d, BF16_FLOPS)
        add("small_mha_bwd", f"({B},{T},{H},{d}) causal", name_dt, err,
            ms_of(lambda: ops.small_mha_bwd(q, k, v, bias, None, dout)),
            ms_of(lambda: ops.small_mha_bwd_plain(q, k, v, bias, None, dout)),
            bwd_bound, lib)
        del leaves, wants, bwd, flat_bwd, q, k, v, dout

        # ---- the dropout twins and their mask: the decoder's shape and the
        # kernels' limit (classify's encoder runs at T = 31)
        for case, B, T, with_bias in (
                (f"({2 * TRAIN_BATCH},17,{H},{d}) causal", 2 * TRAIN_BATCH, 17, True),
                (f"({TRAIN_BATCH},31,{H},{d})", TRAIN_BATCH, 31, False),
                (f"({TRAIN_BATCH},32,{H},{d}) causal", TRAIN_BATCH, 32, True)):
            bias = causal_bias(T) if with_bias else None
            seed = card_seed(torch, dev, 2000 + B * T)
            q, k, v, dout = (headed(B, T, dt) for _ in range(4))
            keep = ops.dropout_keep_mask(B, T, T, H, seed, DROPOUT_RATE, dev)
            plain_keep = ops.dropout_keep_mask_flat_plain(B, T, T, H, seed,
                                                          DROPOUT_RATE, dev)
            flat_keep = ops.dropout_keep_mask_flat(B, T, T, H, seed,
                                                   DROPOUT_RATE, dev)
            torch.cuda.synchronize()
            check(torch.equal(keep, plain_keep) and torch.equal(keep, flat_keep),
                  f"dropout_keep_mask {case}: not the plain (and flat) Philox")
            frac = keep.float().mean().item()
            check(KEEP_FRACTION[0] <= frac <= KEEP_FRACTION[1],
                  f"dropout_keep_mask {case}: keep fraction {frac}")
            args = (q, k, v, bias, seed, None, DROPOUT_RATE)
            fargs = (flat(q), flat(k), flat(v), H, bias, seed, DROPOUT_RATE, None)
            out = ops.small_mha_dropout_fwd(*args)
            check(torch.equal(flat(out), ops.small_mha_dropout_fwd_flat(*fargs)),
                  f"small_mha_dropout_fwd {case} {name_dt}: not K3 on the view")
            fwd_err, ok = _train_close(
                out, ops.small_mha_dropout_fwd_plain(*args, keep=plain_keep), "fwd")
            check(ok and bool(torch.isfinite(out).all()),
                  f"small_mha_dropout_fwd {case} {name_dt}: {fwd_err}")
            grads = ops.small_mha_dropout_bwd(*args, dout)
            flat_grads = ops.small_mha_dropout_bwd_flat(*fargs, flat(dout))
            wants = ops.small_mha_dropout_bwd_plain(*args, dout, keep=plain_keep)
            bwd_err = 0.0
            for which, a, b, c in zip("qkv", grads, wants, flat_grads):
                check(torch.equal(flat(a), c),
                      f"small_mha_dropout_bwd {case} d{which}: not K4 on the view")
                e, ok = _train_close(a, b, "grad")
                check(ok and bool(torch.isfinite(a).all()),
                      f"small_mha_dropout_bwd {case} {name_dt} d{which}: {e}")
                bwd_err = max(bwd_err, e)
            mask = None if bias is None else bias.to(dt)[:, None]
            fwd_lib = bwd_lib = (None, "not timed")
            if timing:
                fwd_lib = library_time(torch, lambda: F.scaled_dot_product_attention(
                    sdpa_views(q), sdpa_views(k), sdpa_views(v), attn_mask=mask,
                    dropout_p=DROPOUT_RATE),
                    "F.scaled_dot_product_attention(dropout_p=0.1) on (B,H,T,64) views")
                gq, gk, gv = (sdpa_views(t).detach().requires_grad_(True)
                              for t in (q, k, v))
                lib_out = F.scaled_dot_product_attention(
                    gq, gk, gv, attn_mask=mask, dropout_p=DROPOUT_RATE)
                bwd_lib = library_time(torch, lambda: torch.autograd.grad(
                    lib_out, (gq, gk, gv), sdpa_views(dout), retain_graph=True),
                    "the backward of F.scaled_dot_product_attention(dropout_p=0.1)")
            fwd_bound = attention_bound(B, T, T, H, d, item, bias, 2)
            bwd_bound = bound(
                attention_bound(B, T, T, H, d, item, bias, 0)[0] * HBM_BYTES_S / 1e3
                + 3 * B * T * H * d * item, 5 * 2.0 * B * H * T * T * d, BF16_FLOPS)
            add("small_mha_dropout_fwd", case, name_dt, fwd_err,
                ms_of(lambda: ops.small_mha_dropout_fwd(*args)),
                ms_of(lambda: ops.small_mha_dropout_fwd_plain(*args)),
                fwd_bound, fwd_lib, keep_fraction=frac)
            add("small_mha_dropout_bwd", case, name_dt, bwd_err,
                ms_of(lambda: ops.small_mha_dropout_bwd(*args, dout)),
                ms_of(lambda: ops.small_mha_dropout_bwd_plain(*args, dout)),
                bwd_bound, bwd_lib)
            if dt == torch.bfloat16:   # the mask does not depend on the dtype
                add("dropout_keep_mask", f"({B},{H},{T},{T})", name_dt, 0.0,
                    ms_of(lambda: ops.dropout_keep_mask(B, T, T, H, seed,
                                                        DROPOUT_RATE, dev)),
                    ms_of(lambda: ops.dropout_keep_mask_flat_plain(
                        B, T, T, H, seed, DROPOUT_RATE, dev)),
                    k5_bound(B * H * T * T),
                    (None, "none: no PyTorch call draws this Philox mask"),
                    keep_fraction=frac)
            del q, k, v, dout, out, grads, flat_grads, wants, keep, plain_keep

        # ---- K12: the head-major layout, per-head / broadcast / no bias
        for T in (17, 30):
            B = SLICE_BATCH
            q, k, v = (torch.randn((B, H, T, d), generator=g, device=dev, dtype=dt)
                       for _ in range(3))
            causal = ops.mask_to_bias(
                torch.ones(T, T, dtype=torch.bool, device=dev).triu(1)[None], T, T)
            per_head = (causal[:, None] + torch.randn((B, H, T, T), generator=g,
                                                      device=dev)).contiguous()
            for label, bias in (("per-head bias", per_head),
                                ("head-broadcast causal", causal[:, None].expand(
                                    B, 1, T, T).contiguous()),
                                ("no bias", None)):
                got = ops.fused_mha(q, k, v, bias)
                want = ops.fused_mha_plain(q, k, v, bias)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                check(err <= K1_TOL[name_dt] and bool(torch.isfinite(got).all()),
                      f"fused_mha T={T} {label} {name_dt}: max abs err {err}")
                mask = None if bias is None else bias.to(dt)
                n_bytes = 4 * B * H * T * d * item + (0 if bias is None else
                                                      bias.numel() * 4)
                add("fused_mha", f"({B},{H},{T},{d}) {label}", name_dt, err,
                    ms_of(lambda: ops.fused_mha(q, k, v, bias)),
                    ms_of(lambda: ops.fused_mha_plain(q, k, v, bias)),
                    bound(n_bytes, 2 * 2.0 * B * H * T * T * d, BF16_FLOPS),
                    library_time(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask),
                        "F.scaled_dot_product_attention (its own layout)")
                    if timing else (None, "not timed"))
            del q, k, v, per_head, got, want
        torch.cuda.empty_cache()

    for kernel, rs in rows.items():
        for r in rs:
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            print(f"phase 3e {kernel} {r['case']} {r['dtype']}: max abs err "
                  f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {lib}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# K13 at each path's shape: (label, rows, slots L, heads, steps a batch
# runs, decoder layers); d = 64.  The CTC beam runs 32 steps of L = 33,
# the lrw1000 decoders 16 of L = 17, each step once a layer.
K13_SHAPES = (("CTC beam (2560,33,12x64)", 2560, 33, 12, 32, 6),
              ("lrw1000 beam5 (2560,17,8x64)", 2560, 17, 8, 16, 6),
              ("lrw1000 greedy (512,17,8x64)", 512, 17, 8, 16, 6))


def k13_bytes(N, HD, item, step):
    """Bytes K13 must move at one step: q, k_new and v_new read, slots
    0..step-1 of both caches read, slot ``step`` of both and the output
    written."""
    return N * HD * item * (2 * step + 6)


def phase_cached_attention(torch, dev, timing=True):
    """Phase 3f: K13 cached_attention_step against its plain version at
    each path's shape (K13_SHAPES), f32 and bf16, at steps 0, L // 2 and
    L - 1, on caches whose every slot holds values: the output within
    K1_TOL, the caches afterwards bit-identical to the plain version's
    (slot ``step`` = k_new / v_new exactly, every other slot untouched).
    With ``timing``, in bf16: cuda_ms of every step a batch runs, summed
    over the steps and layers against the bytes bound (k13_bytes), and at
    the three steps the plain version's time and one
    F.scaled_dot_product_attention call on the sliced cache (a yardstick;
    it writes no slot)."""
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(13)
    d = 64
    out = {"rows": [], "per_batch": {}}
    for label, N, L, H, steps, layers in K13_SHAPES:
        HD = H * d
        for dt in (torch.float32, torch.bfloat16):
            name_dt = str(dt).split(".")[-1]
            item = torch.tensor([], dtype=dt).element_size()
            kc, vc = (torch.randn((N, L, HD), generator=g, device=dev, dtype=dt)
                      for _ in range(2))
            q, k_new, v_new = (torch.randn((N, HD), generator=g, device=dev, dtype=dt)
                               for _ in range(3))
            for step in (0, L // 2, L - 1):
                kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                before = ops.cached_attention_step.launches
                got = ops.cached_attention_step(q, k_new, v_new, kk, vk, step, H)
                want = ops.cached_attention_step_plain(q, k_new, v_new, kp, vp, step, H)
                torch.cuda.synchronize()
                check(ops.cached_attention_step.launches == before + 1,
                      f"3f K13 {label}: not launched")
                err = (got.float() - want.float()).abs().max().item()
                check(err <= K1_TOL[name_dt] and bool(torch.isfinite(got).all()),
                      f"3f K13 {label} {name_dt} step {step}: max abs err {err}")
                check(torch.equal(kk, kp) and torch.equal(vk, vp),
                      f"3f K13 {label} {name_dt} step {step}: caches differ from "
                      f"the plain version's")
                check(torch.equal(kk[:, step + 1:], kc[:, step + 1:])
                      and torch.equal(kk[:, :step], kc[:, :step])
                      and torch.equal(vk[:, step + 1:], vc[:, step + 1:])
                      and torch.equal(vk[:, :step], vc[:, :step]),
                      f"3f K13 {label} {name_dt} step {step}: a slot other than "
                      f"{step} was written")
                row = dict(case=label, dtype=name_dt, step=step, max_abs_err=err)
                if timing and dt == torch.bfloat16:
                    bound_ms = k13_bytes(N, HD, item, step) / HBM_BYTES_S * 1e3
                    kv = (kc[:, :step + 1].view(N, step + 1, H, d).transpose(1, 2),
                          vc[:, :step + 1].view(N, step + 1, H, d).transpose(1, 2))
                    lib = library_time(
                        torch, lambda: F.scaled_dot_product_attention(
                            q.view(N, H, 1, d), *kv, scale=d ** -0.5),
                        "F.scaled_dot_product_attention on the sliced cache")
                    row.update(
                        ms=cuda_ms(torch, lambda: ops.cached_attention_step(
                            q, k_new, v_new, kk, vk, step, H)),
                        plain_ms=cuda_ms(torch, lambda: ops.cached_attention_step_plain(
                            q, k_new, v_new, kp, vp, step, H)),
                        bound_ms=bound_ms, bound_by="bytes", library_ms=lib[0],
                        library_call=lib[1])
                    row["roofline"] = bound_ms / row["ms"]
                out["rows"].append(row)
                print(f"3f K13 {json.dumps(row)}", flush=True)
                del kk, vk, kp, vp, got, want
            if timing and dt == torch.bfloat16:
                kk, vk = kc.clone(), vc.clone()
                ms = [cuda_ms(torch, lambda s=s: ops.cached_attention_step(
                    q, k_new, v_new, kk, vk, s, H)) for s in range(steps)]
                bound_ms = [k13_bytes(N, HD, item, s) / HBM_BYTES_S * 1e3
                            for s in range(steps)]
                out["per_batch"][label] = dict(
                    launches=steps * layers, ms=layers * sum(ms),
                    bound_ms=layers * sum(bound_ms), roofline=sum(bound_ms) / sum(ms),
                    step_ms=ms)
                print(f"3f K13 {label} per batch ({steps} steps x {layers} layers): "
                      f"{layers * sum(ms):.3f} ms, bound {layers * sum(bound_ms):.3f} ms, "
                      f"{100 * sum(bound_ms) / sum(ms):.1f}% of it", flush=True)
                del kk, vk
            del kc, vc, q, k_new, v_new
    torch.cuda.empty_cache()
    return out


def phase_slice(torch, np, dev):
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches, recognize_batch)
    from sbl_for_multilingual_lip_reading_tpu_torch.vocab import decode_ids

    cfg = C.sbl()
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    V, maxlen = cfg.decoder.vocab_size, cfg.decoder.maxlen
    rng = np.random.default_rng(0)

    def clips(batch):
        return torch.from_numpy(rng.integers(0, 256, size=(batch, T, raw, raw),
                                             dtype=np.uint8)).to(dev)

    # the kernel path against the plain path, same weights and clips
    small = clips(SLICE_CHECK_BATCH)
    for dtype in ("float32", "bfloat16"):
        runs = []
        for kernels in (True, False):
            model = build_model(dataclasses.replace(
                cfg, compute_dtype=dtype, use_pallas_attention=kernels),
                dev, seed=0)
            runs.append(recognize_batch(model, small, crop))
            del model
        torch.cuda.synchronize()
        kern, plain = runs
        diffs = [(a - b).abs() for a, b in ((kern.logits_l2r, plain.logits_l2r),
                                            (kern.logits_r2l, plain.logits_r2l))]
        first = max(d[:, 0].max().item() for d in diffs)
        every = max(d.max().item() for d in diffs)
        agree = torch.cat([(kern.ys_l2r == plain.ys_l2r)[:, 1:],
                           (kern.ys_r2l == plain.ys_r2l)[:, 1:]]).float().mean().item()
        print(f"phase 4 {dtype} B={SLICE_CHECK_BATCH} kernel vs plain path: "
              f"first-step logits max abs diff {first:.3g} (tol "
              f"{LOGIT_TOL[dtype]}), all steps {every:.3g}, token agreement "
              f"{agree:.4f} (min {MIN_TOKEN_AGREEMENT[dtype]})")
        check(first <= LOGIT_TOL[dtype],
              f"{dtype} first-step logits differ by {first}")
        check(agree >= MIN_TOKEN_AGREEMENT[dtype],
              f"{dtype} tokens agree only {agree}")
        del runs, kern, plain
    torch.cuda.empty_cache()

    # bf16 recognize at B=512: the main path
    model = build_model(cfg, dev, seed=0)
    batch = clips(SLICE_BATCH)
    recognize_batch(model, batch, crop)          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = recognize_batch(model, batch, crop)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = expected_launches(cfg)
    print(f"phase 4 bf16 B={SLICE_BATCH} launches per batch: {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    for ys in (out.ys_l2r, out.ys_r2l):
        check(tuple(ys.shape) == (SLICE_BATCH, maxlen + 1),
              f"tokens shape {tuple(ys.shape)}")
        check(int(ys.min()) >= 0 and int(ys.max()) < V, "token out of range")
    for lg in (out.logits_l2r, out.logits_r2l):
        check(tuple(lg.shape) == (SLICE_BATCH, maxlen, V), "logits shape")
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
    words = [" ".join(decode_ids(out.ys_l2r[i].tolist())) for i in (0, 1)]
    print(f"phase 4 bf16 B={SLICE_BATCH}: clip 0 l2r: [{words[0]}]; clip 1 "
          f"l2r: [{words[1]}]")
    return launches


def _grad_errors(kern, plain):
    """Per parameter ||kernel - plain|| / max(||plain||, 1e-3 * G), G the
    largest per-parameter gradient norm: the floor covers the gradients
    that are zero in exact arithmetic and carry only rounding noise (the
    key projections' biases: a softmax does not see a shift of all its
    scores)."""
    norms = {n: g.norm().item() for n, g in plain.items()}
    floor = 1e-3 * max(norms.values())
    return {n: (kern[n] - g).norm().item() / max(norms[n], floor)
            for n, g in plain.items()}


def train_batch(torch, np, dev, cfg, data, n, seed):
    """The first batch of ``n`` of a shuffled epoch with its plans, on the
    card."""
    from sbl_for_multilingual_lip_reading_tpu_torch.data import Batcher
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
        attach_plans)
    b = attach_plans(next(iter(Batcher(data, n, seed=seed))),
                     np.random.default_rng(seed), cfg)
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in b.items()}


def kernel_vs_plain_step(torch, dev, cfg, small, label):
    """One train step of ``cfg``'s workload on the kernel path and one on
    the plain path (the kernels' plain versions), same weights, batch and
    generator seed, so the same dropout masks and coins: loss, every
    gradient and the BN running statistics, f32 and bf16."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        make_train_step)
    for dtype in ("float32", "bfloat16"):
        runs = []
        for kernels in (True, False):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    use_pallas_attention=kernels)
            model = build_model(c, dev, seed=0)
            step = make_train_step(model, make_optimizer(model, c.optim), c)
            loss = step(small, torch.Generator().manual_seed(5))["loss"].item()
            runs.append((loss, {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()},
                         {n: b.clone() for n, b in model.named_buffers()
                          if "running" in n}))
            del model, step
        (lk, gk, bk), (lp, gp, bp) = runs
        errs = _grad_errors(gk, gp)
        worst = max(errs, key=errs.get)
        bn_err = max((bk[n] - b).abs().max().item() for n, b in bp.items())
        print(f"{label} {dtype} B={TRAIN_CHECK_BATCH} kernel vs plain path: "
              f"loss {lk:.6f} vs {lp:.6f} (tol {TRAIN_LOSS_TOL[dtype]}); "
              f"gradient rel err max {errs[worst]:.3g} at {worst}, median "
              f"{statistics.median(errs.values()):.3g} (tol "
              f"{TRAIN_GRAD_TOL[dtype]}); BN running stats max abs diff "
              f"{bn_err:.3g} (tol {TRAIN_BN_TOL[dtype]})")
        check(abs(lk - lp) <= TRAIN_LOSS_TOL[dtype], f"{dtype} losses differ")
        check(errs[worst] <= TRAIN_GRAD_TOL[dtype],
              f"{dtype} gradient of {worst} differs by {errs[worst]}")
        check(bn_err <= TRAIN_BN_TOL[dtype], f"{dtype} BN stats differ")
        del runs, gk, gp
    torch.cuda.empty_cache()


def run_train_steps(torch, np, step, batch, B, label):
    """TRAIN_WARMUP + TRAIN_STEPS steps on one resident batch: the losses
    finite, and the peak memory of the last TRAIN_STEPS."""
    gen = torch.Generator().manual_seed(3)
    for _ in range(TRAIN_WARMUP):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch, gen)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)), f"{label}: non-finite losses {losses}")
    print(f"{label} bf16 B={B}: {TRAIN_STEPS} steps after {TRAIN_WARMUP}, peak "
          f"memory {peak_gb:.2f} GB; losses {', '.join(f'{x:.4f}' for x in losses)}")
    return dict(peak_gb=peak_gb, losses=losses)


def _cli_train(torch, cli, ops, argv):
    """`cli train` with the launch counts set to 0 just before and read just
    after: (trainer, fit's result, counts)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tr, out = cli.run_train(argv)
    torch.cuda.synchronize()
    return tr, out, ops.launch_counts()


def phase_tiny(torch, np, dev):
    """The tiny preset (``config.tiny_test("sbl")``: d_k = 16, as any `cli
    --d_model/--n_head` choice with d != 64) through recognize and one train
    step on the card, its kernels built for d = 16.  Recognize launches K1
    (and K11 with the fused decoder layer) as expected_launches counts and
    agrees with the plain path (f32 and bf16; f32 also fused); the train
    step launches K2, K3 and K4 as steps.expected_launches counts and
    equals the plain path's step."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches, recognize_batch)
    from sbl_for_multilingual_lip_reading_tpu_torch.training import steps
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)

    cfg = C.tiny_test("sbl")
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    clips = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(TINY_BATCH, T, raw, raw), dtype=np.uint8)).to(dev)
    out = {}
    # (dtype, K11 fused layer, K10 on the eligible block: C = 8 at S = 8)
    for dtype, fused, resblock in (("float32", False, False), ("bfloat16", False, False),
                                   ("float32", True, False), ("float32", True, True),
                                   ("bfloat16", True, True)):
        runs = []
        for kernels in (True, False):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    use_pallas_attention=kernels,
                                    use_fused_decoder_layer=fused)
            model = build_model(c, dev, seed=0, use_pallas_resblock=resblock)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            runs.append(recognize_batch(model, clips, crop))
            torch.cuda.synchronize()
            if kernels:
                launches = ops.launch_counts()
                want = expected_launches(c, use_pallas_resblock=resblock)
            del model
        kern, plain = runs
        first = max((a[:, 0] - b[:, 0]).abs().max().item() for a, b in (
            (kern.logits_l2r, plain.logits_l2r), (kern.logits_r2l, plain.logits_r2l)))
        agree = torch.cat([(kern.ys_l2r == plain.ys_l2r)[:, 1:],
                           (kern.ys_r2l == plain.ys_r2l)[:, 1:]]).float().mean().item()
        label = (f"phase 4b tiny sbl {dtype}{' fused layer' if fused else ''}"
                 f"{' resblock' if resblock else ''}")
        print(f"{label} B={TINY_BATCH} recognize: K1 launches "
              f"{launches['small_mha_flat']}, K11 {launches['fused_decoder_layer']}, "
              f"K10 {launches['fused_resblock']} (expected {want['small_mha_flat']}, "
              f"{want['fused_decoder_layer']}, {want['fused_resblock']}); "
              f"kernel vs plain path first-step logits {first:.3g} (tol "
              f"{LOGIT_TOL[dtype]}), token agreement {agree:.4f}")
        check(launches == want, f"{label}: launches {launches} != {want}")
        check(launches["small_mha_flat"] > 0, f"{label}: K1 not launched")
        check(launches["fused_resblock"] > 0 or not resblock, f"{label}: K10 not launched")
        check(launches["fused_decoder_layer"] > 0 or not fused, f"{label}: K11 not launched")
        out[f"{label} K1"] = launches["small_mha_flat"]
        check(first <= LOGIT_TOL[dtype], f"{label}: logits differ by {first}")
        check(agree >= MIN_TOKEN_AGREEMENT[dtype], f"{label}: tokens agree {agree}")

    # one train step: K2, K3 and K4 on the card
    data = SyntheticLipDataset(size=TINY_BATCH, frames=T, raw_size=raw, seed=0)
    batch = train_batch(torch, np, dev, cfg, data, TINY_BATCH, 1)
    runs = []
    for kernels in (True, False):
        c = dataclasses.replace(cfg, use_pallas_attention=kernels)
        model = build_model(c, dev, seed=0)
        step = steps.make_train_step(model, make_optimizer(model, c.optim), c)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        loss = step(batch, torch.Generator().manual_seed(5))["loss"].item()
        torch.cuda.synchronize()
        runs.append((loss, ops.launch_counts(),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
        del model, step
    (lk, launches, gk), (lp, _, gp) = runs
    want = steps.expected_launches(cfg)
    fwd, bwd = "small_mha_dropout_fwd_flat", "small_mha_dropout_bwd_flat"
    errs = _grad_errors(gk, gp)
    print(f"phase 4b tiny sbl float32 B={TINY_BATCH} train step: launches K2 "
          f"{launches['stack_frames']}, K3 {launches[fwd]}, K4 {launches[bwd]} "
          f"(expected {want['stack_frames']}, {want[fwd]}, {want[bwd]}); loss "
          f"{lk:.6f} vs plain path {lp:.6f}, gradient rel err max "
          f"{max(errs.values()):.3g}")
    check(launches == want, f"tiny train step launches {launches} != {want}")
    check(launches[fwd] > 0 and launches[bwd] > 0, "tiny train step: K3/K4 not launched")
    check(np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_TOL["float32"],
          f"tiny train step losses {lk} vs {lp}")
    check(max(errs.values()) <= TRAIN_GRAD_TOL["float32"], "tiny gradients differ")
    out["train step K3"], out["train step K4"] = launches[fwd], launches[bwd]
    return out


def phase_train(torch, np, dev):
    """The train slice: kernel path vs plain path, then the B=240 bf16 step
    through the entry point, then its run on one resident batch."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches, make_sbl_train_step)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
        train_steps)

    cfg = C.sbl()
    data = SyntheticLipDataset(size=TRAIN_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0)

    def device_batch(n, seed):
        return train_batch(torch, np, dev, cfg, data, n, seed)

    kernel_vs_plain_step(torch, dev, cfg, device_batch(TRAIN_CHECK_BATCH, 1),
                         "phase 5")

    # the main path: one bf16 step at B=240 through the entry point
    model = build_model(cfg, dev, seed=0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    result = train_steps(cfg, data, 1, dev, seed=0, model=model)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = expected_launches(cfg)
    print(f"phase 5 bf16 B={TRAIN_BATCH} launches per step: {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    loss = result.history[0]["loss"]
    check(np.isfinite(loss), f"non-finite loss {loss}")
    state = model.state_dict()
    still = [n for n, _ in model.named_parameters() if torch.equal(before[n], state[n])]
    check(not still, f"parameters that did not move: {still[:5]}")
    stats = [n for n in state if "running" in n]
    check(all(not torch.equal(before[n], state[n]) for n in stats),
          "BN running statistics did not move")
    print(f"phase 5 bf16 B={TRAIN_BATCH} step 1: loss {loss:.4f}, all "
          f"{len(before) - len(stats)} parameter tensors and {len(stats)} BN "
          f"statistics moved")
    del before, state

    # the train step on one resident batch
    step = make_sbl_train_step(model, result.optimizer, cfg)
    step.state.step = len(result.history)
    return launches, run_train_steps(torch, np, step, device_batch(TRAIN_BATCH, 2),
                                     TRAIN_BATCH, "phase 5")


def phase_ingest_kernels(torch, np, dev, timing=True):
    """K6 against its plain version, bit for bit: at (240,30,96,96) -> 88
    on the vector route, timed with its plain version and bound; and on
    INGEST_CASES, each on the route it expects (``timing`` False: the
    checks alone, every time NaN)."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data.transforms import (
        make_train_plans)
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
        attach_plans)

    def ms_of(fn):
        return cuda_ms(torch, fn) if timing else float("nan")
    cfg = C.sbl()
    B, T, raw, crop = TRAIN_BATCH, cfg.data.frames, cfg.data.raw_size, \
        cfg.data.crop_size
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (B, T, raw, raw), dtype=np.uint8)
    # LRW (per-frame crops) and LRW-1000 (per-clip) clips, a quarter padded
    batch = attach_plans({"clip_u8": clips,
                          "lang_id": (np.arange(B) % 2).astype(np.int32)},
                         rng, cfg)
    n_frames = np.where(rng.random(B) < 0.25, rng.integers(1, T, B), T)
    args = [torch.as_tensor(np.asarray(batch[k])).to(dev)
            for k in ("clip_u8", "offsets", "flip", "frame_map")]
    nf = torch.as_tensor(n_frames.astype(np.int32)).to(dev)
    # the bytes this run's plans need: each valid output slot's source
    # crop once, the plans, the output
    fmap = np.asarray(batch["frame_map"])
    sources = {(b, int(fmap[b, t])) for b in range(B) for t in range(n_frames[b])}
    plan_bytes = sum(a.numel() * a.element_size() for a in args[1:]) + 4 * B
    ingest = []
    for dt in (torch.float32, torch.bfloat16):
        got = ops.ingest_train(*args, crop, dt, n_frames=nf)
        want = ops.ingest_train_plain(*args, crop, dt, n_frames=nf)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K6 {dt} is not bit-exact")
        route = ops.ingest.route(args[0], got, crop)
        check(route > 1, f"K6 {dt} at the train step's shape: scalar route")
        n_bytes = len(sources) * crop * crop + plan_bytes + got.numel() * got.element_size()
        bound_ms, bound_by = bound(n_bytes, 2.0 * got.numel(), F32_OPS)
        ingest.append(dict(
            case=f"({B},{T},{raw},{raw}) -> {crop}", dtype=dtype_name(got),
            route=f"{route}-output pieces", max_abs_err=0.0, bound_ms=bound_ms,
            bound_by=bound_by,
            ms=ms_of(lambda: ops.ingest_train(*args, crop, dt, n_frames=nf)),
            plain_ms=ms_of(lambda: ops.ingest_train_plain(
                *args, crop, dt, n_frames=nf)),
            library_ms=None, library_call="none: no single PyTorch call "
            "gathers, crops, flips and normalizes"))
        del got, want
    for r in ingest:
        print(f"phase 3c ingest_train {r['case']} {r['dtype']} ({r['route']}): "
              f"bit-exact, kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.0%} of it)")

    # the routes off the train step's shape, checked bit for bit; the
    # output at an element offset goes through the C entry, since the
    # wrapper allocates its own output
    lib = _build.library()
    for name, (B_, T_, raw_, crop_), offset, out_offset, expect in INGEST_CASES:
        rng = np.random.default_rng(5 + crop_ + offset)
        buf = torch.as_tensor(rng.integers(0, 256, B_ * T_ * raw_ * raw_ + offset,
                                           dtype=np.uint8)).to(dev)
        clips_ = buf[offset:].view(B_, T_, raw_, raw_)
        plans = make_train_plans(rng, B_, T_, raw_, crop_, 0.3)
        plans = [torch.as_tensor(np.asarray(a)).to(dev) for a in plans]
        nf_ = torch.as_tensor(np.where(rng.random(B_) < 0.25, rng.integers(1, T_, B_), T_)
                              .astype(np.int32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            want = ops.ingest_train_plain(clips_, *plans, crop_, dt, n_frames=nf_)
            if out_offset:
                out = torch.full((want.numel() + out_offset,), float("nan"), dtype=dt,
                                 device=dev)[out_offset:].view(want.shape)
                off32, fm32 = (plans[i].to(torch.int32).contiguous() for i in (0, 2))
                fl8 = plans[1].to(torch.uint8).contiguous()
                err = lib.sbl_ingest_train(
                    clips_.data_ptr(), off32.data_ptr(), fl8.data_ptr(), fm32.data_ptr(),
                    nf_.data_ptr(), out.data_ptr(), B_, T_, raw_, raw_, crop_,
                    ops.ingest.INV_STD, ops.ingest.SHIFT, 0 if dt == torch.float32 else 1,
                    dev.index, torch.cuda.current_stream(dev).cuda_stream)
                _build.check(err, "ingest_train at an output offset")
                got = out
            else:
                out = torch.empty_like(want)
                got = ops.ingest_train(clips_, *plans, crop_, dt, n_frames=nf_)
            route = "vector" if ops.ingest.route(clips_, out, crop_) > 1 else "scalar"
            check(route == expect, f"K6 {name} {dt}: {route} route, not {expect}")
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K6 {name} {dt} is not bit-exact")
        print(f"phase 3c ingest_train {name} ({B_},{T_},{raw_},{raw_}) -> {crop_}: "
              f"bit-exact in f32 and bf16, {expect} route")
    return ingest


def phase_ingest_bn_kernels(torch, np, dev):
    """K6 against its plain version (``phase_ingest_kernels``); K7 and K8
    against theirs on the frontend's BatchNorm shapes; times of kernel,
    plain version and library call; the bounds."""
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    ingest = phase_ingest_kernels(torch, np, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    stats = []
    cases = [(name, (BN_FRAMES,) + shape, per_step, 0)
             for name, shape, per_step in BN_SHAPES]
    cases.append(("check layer4", (30 * TRAIN_CHECK_BATCH, 512, 3, 3), 0, 0))
    cases += [(name, shape, 0, offset) for name, shape, offset in BN_SCALAR_CASES]
    scalar = {name for name, _, _ in BN_SCALAR_CASES}

    def at_offset(t, offset):
        """t's values in a contiguous tensor starting ``offset`` elements
        into its buffer."""
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    for dt in (torch.float32, torch.bfloat16):
        for name, shape, per_step, offset in cases:
            C_ = shape[1]
            shift = torch.randn(C_, 1, 1, generator=g, device=dev)
            x = at_offset((torch.randn(shape, generator=g, device=dev) * 2
                           + shift).to(dt), offset)
            dy = at_offset(torch.randn(shape, generator=g, device=dev).to(dt), offset)
            route = "vector" if ops.batchnorm.route(dy, x) > 1 else "scalar"
            check(route == ("scalar" if name in scalar else "vector"),
                  f"K7/K8 {name} {dt}: {route} route")
            n = x.numel() // C_
            s, q = ops.channel_sums(x)
            s2, q2 = ops.channel_sums(x)
            ps, pq = ops.channel_sums_plain(x)
            xf = x.float()
            abs_x = xf.abs().sum((0, 2, 3))
            k7_err = max(((s - ps).abs() / abs_x).max().item(),
                         ((q - pq).abs() / pq).max().item())
            check(torch.equal(s, s2) and torch.equal(q, q2),
                  f"K7 {name} {dt}: two calls differ")
            check(k7_err <= STAT_TOL, f"K7 {name} {dt}: rel err {k7_err}")
            mean = s / n
            inv = torch.rsqrt(q / n - mean * mean + 1e-5)
            sd, sx = ops.channel_sums_pair(dy, x, mean, inv)
            sd2, sx2 = ops.channel_sums_pair(dy, x, mean, inv)
            psd, psx = ops.channel_sums_pair_plain(dy, x, mean, inv)
            dyf = dy.float()
            abs_dy = dyf.abs().sum((0, 2, 3))
            abs_dyx = (dyf * ((xf - mean[:, None, None]) * inv[:, None, None])
                       ).abs().sum((0, 2, 3))
            k8_err = max(((sd - psd).abs() / abs_dy).max().item(),
                         ((sx - psx).abs() / abs_dyx).max().item())
            del xf, dyf
            check(torch.equal(sd, sd2) and torch.equal(sx, sx2),
                  f"K8 {name} {dt}: two calls differ")
            check(k8_err <= STAT_TOL, f"K8 {name} {dt}: rel err {k8_err}")
            weight = torch.ones(C_, device=dev)
            k7_lib, k7_call = library_time(
                torch, lambda: torch.batch_norm_stats(x, 1e-5),
                "torch.batch_norm_stats (mean, invstd)")
            k8_lib, k8_call = library_time(
                torch, lambda: torch.batch_norm_backward_reduce(
                    dy, x, mean, inv, weight, True, True, True),
                "torch.batch_norm_backward_reduce (sum dy, sum dy*(x-mean), "
                "grad weight, grad bias)")
            size = x.numel() * x.element_size()
            stats.append(dict(
                case=f"{name} {tuple(shape)}", dtype=dtype_name(x), route=route,
                per_step=per_step, k7_err=k7_err, k8_err=k8_err,
                k7_ms=cuda_ms(torch, lambda: ops.channel_sums(x)),
                k7_plain_ms=cuda_ms(torch, lambda: ops.channel_sums_plain(x)),
                k7_lib_ms=k7_lib, k7_lib_call=k7_call,
                k7_bound=bound(size + 8 * C_, 3.0 * x.numel(), F32_OPS),
                k8_ms=cuda_ms(torch, lambda: ops.channel_sums_pair(dy, x, mean, inv)),
                k8_plain_ms=cuda_ms(torch, lambda: ops.channel_sums_pair_plain(
                    dy, x, mean, inv)),
                k8_lib_ms=k8_lib, k8_lib_call=k8_call,
                k8_bound=bound(2 * size + 16 * C_, 5.0 * x.numel(), F32_OPS)))
            del x, dy
            torch.cuda.empty_cache()
    for r in stats:
        print(f"phase 3c BN {r['case']} {r['dtype']} ({r['route']} route): K7 rel err "
              f"{r['k7_err']:.3g}, {r['k7_ms']:.4f} ms (plain {r['k7_plain_ms']:.4f}, "
              f"library {r['k7_lib_ms']}, bound {r['k7_bound'][0]:.4f}, "
              f"{r['k7_bound'][0] / r['k7_ms']:.0%} of it); K8 rel err "
              f"{r['k8_err']:.3g}, {r['k8_ms']:.4f} ms (plain "
              f"{r['k8_plain_ms']:.4f}, library {r['k8_lib_ms']}, bound "
              f"{r['k8_bound'][0]:.4f}, {r['k8_bound'][0] / r['k8_ms']:.0%} of it); "
              f"both bit-identical over two calls")
    for dt in ("float32", "bfloat16"):
        rows = [r for r in stats if r["dtype"] == dt]
        print(f"phase 3c BN {dt} per B=240 step ({sum(r['per_step'] for r in rows)}"
              f" launches each): K7 {sum(r['k7_ms'] * r['per_step'] for r in rows):.3f}"
              f" ms (bound {sum(r['k7_bound'][0] * r['per_step'] for r in rows):.3f}),"
              f" K8 {sum(r['k8_ms'] * r['per_step'] for r in rows):.3f} ms (bound "
              f"{sum(r['k8_bound'][0] * r['per_step'] for r in rows):.3f})")
    return ingest, stats


def _set_switches(on: bool) -> None:
    for name in ("PALLAS_INGEST", "PALLAS_BN"):
        if on:
            os.environ[name] = "1"
        else:
            os.environ.pop(name, None)


def phase_entry(torch, np, dev):
    """The training entry point with PALLAS_INGEST=1 and PALLAS_BN=1."""
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches as recognize_launches)
    from sbl_for_multilingual_lip_reading_tpu_torch.training import checkpoint
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches, make_sbl_train_step)

    _set_switches(True)
    cfg = C.sbl()
    data = SyntheticLipDataset(size=TRAIN_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0)
    kernel_vs_plain_step(torch, dev, cfg, train_batch(
        torch, np, dev, cfg, data, TRAIN_CHECK_BATCH, 1), "phase 6")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    stage1, stage2 = str(CKPT_DIR / "stage1"), str(CKPT_DIR / "stage2")
    common = ["--workload", "sbl", "--synthetic", "--synthetic-size",
              str(ENTRY_STEPS * TRAIN_BATCH), "--max-eval-batches", "1"]
    tr, out, launches = _cli_train(torch, cli, ops, common + [
        "--epochs", "1", "--max-steps-per-epoch", str(ENTRY_STEPS),
        "--save-dir", stage1])
    n_eval = len(tr.valid_datasets)
    per_step = expected_launches(cfg)
    expected = {k: ENTRY_STEPS * per_step[k] + n_eval * v
                for k, v in recognize_launches(cfg).items()}
    print(f"phase 6 cli train: {ENTRY_STEPS} steps of B={TRAIN_BATCH} and "
          f"{n_eval} eval batches; launches {launches} "
          f"(expected {expected}; per step {per_step})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    check((per_step["ingest_train"], per_step["channel_sums"],
           per_step["channel_sums_pair"]) == (1, 20, 20),
          f"per-step K6/K7/K8 launches {per_step}")
    check(np.isfinite(out["train_loss"]), f"non-finite loss {out['train_loss']}")
    for path in (stage1, stage1 + "_best"):
        check(os.path.isfile(os.path.join(path, checkpoint.FILE)),
              f"no checkpoint in {path}")
    print(f"phase 6 cli train: loss {out['train_loss']:.4f}, eval "
          f"{ {k: v for k, v in out.items() if k != 'train_loss'} }; "
          f"checkpoint and _best mirror written")

    got = cli.run_test(common + ["--checkpoint", stage1])
    _, test_sets = cli.make_datasets(tr.cfg, cli.build_argparser().parse_args(
        common), "test")
    want = {k: tr.validate_seq2seq(ds, 1) for k, ds in test_sets.items()}
    check(got == want, f"cli test {got} != in-memory model {want}")
    print(f"phase 6 cli test: {got}, equal to the in-memory model's")
    del tr
    torch.cuda.empty_cache()

    tr2, _ = cli.run_train(common + [
        "--workload", "sbl_stage2", "--epochs", "1", "--max-steps-per-epoch", "1",
        "--transfer-from", stage1, "--freeze", "frontend,encoder",
        "--save-dir", stage2])
    start = checkpoint.load(stage1)["model"]
    frozen = moved = 0
    for name, p in tr2.model.named_parameters():
        same = torch.equal(p.detach().cpu(), start[name])
        if name.startswith(("frontend.", "encoder.")):
            check(same, f"frozen {name} moved")
            frozen += 1
        else:
            check(not same, f"{name} did not move")
            moved += 1
    check(tr2.state.step == 1 and tr2.cfg.decoder.teacher_forcing_rate == 0.1,
          "stage 2 did not take its step")
    print(f"phase 6 stage-2 transfer: {frozen} frozen tensors bit-identical, "
          f"{moved} decoder tensors moved")
    del tr2, start
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    # the B=240 step with the switches off and on
    models = {}
    for on in (False, True):
        _set_switches(on)
        model = build_model(cfg, dev, seed=0)
        models[on] = make_sbl_train_step(model, make_optimizer(model, cfg.optim),
                                         cfg)
    batch = train_batch(torch, np, dev, cfg, data, TRAIN_BATCH, 2)
    gen = torch.Generator().manual_seed(3)
    turns = []
    for on in (False, True):
        _set_switches(on)
        step = models[on]
        step(batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(batch, gen)["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        check(all(torch.isfinite(x).item() for x in losses), "non-finite loss")
        turns.append(dict(switches=on,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        print(f"phase 6 B={TRAIN_BATCH} bf16 switches {'on ' if on else 'off'}: "
              f"{TRAIN_STEPS} steps, peak {turns[-1]['peak_gb']:.2f} GB")
    _set_switches(False)
    return launches, dict(turns=turns, loss=out["train_loss"])


def _layer_for_check(torch, dev, dtype, seed, n_head=None, d_model=None):
    """A full-width ``_SBLLayer`` with seeded weights and non-trivial
    biases and LayerNorm vectors (their init is zeros and ones); with
    ``n_head``, that many heads of width d_model / n_head; with
    ``d_model``, that width and an FFN twice as wide."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.models import init_weights
    from sbl_for_multilingual_lip_reading_tpu_torch.models.decoder_sbl import _SBLLayer
    d = C.sbl().dims
    if d_model is not None:
        d = dataclasses.replace(d, d_model=d_model, d_inner=2 * d_model)
    if n_head is not None:
        d = dataclasses.replace(d, n_head=n_head, d_k=d.d_model // n_head,
                                d_v=d.d_model // n_head)
    layer = _SBLLayer(d.d_model, d.n_head, d.d_k, d.d_v, d.d_inner, dtype, True,
                      d.dropout, use_fused_layer=True)
    g = torch.Generator().manual_seed(seed)
    init_weights(layer, g)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            elif "layer_norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return layer.to(dev).eval(), d


def phase_eval_kernels(torch, np, dev, frames=RESBLOCK_FRAMES, batch=SLICE_BATCH,
                       timing=True):
    """K9, K10 and K11 against their plain versions at the eval paths'
    shapes; times of kernel, plain version and module composition; bounds."""
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
    from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import BasicBlock
    from sbl_for_multilingual_lip_reading_tpu_torch.ops.decoder_layer import (
        layer_params_to_args)
    cfg = C.sbl()
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    g = torch.Generator(device=dev).manual_seed(7)

    def ms_of(fn):
        return cuda_ms(torch, fn) if timing else float("nan")

    # ---- K9 at the eval ingest's shape
    clips = torch.randint(0, 256, (batch, T, raw, raw), generator=g, device=dev,
                          dtype=torch.uint8)
    k9 = []
    for dt in (torch.float32, torch.bfloat16):
        got = ops.stack_frames_u8(clips, crop, dt)
        want = ops.stack_frames_u8_plain(clips, crop, dt)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K9 {dt} is not bit-exact")
        del want
        two_pass = ops.stack_frames(device_ingest(clips, crop, dt))
        diff = (got.float() - two_pass.float()).abs().max().item()
        # device_ingest normalizes as (x/255 - MEAN)/STD, other roundings:
        # up to two f32 ulps apart (an ulp is 2^-22 for |x| in [2, 4)); in
        # bf16 all 256 input values round alike
        check(diff <= (2.0 ** -20 if dt == torch.float32 else 0.0),
              f"K9 {dt} vs device_ingest + K2: max abs diff {diff}")
        del two_pass
        n_bytes = clips.numel() + got.numel() * got.element_size()
        bound_ms, bound_by = bound(n_bytes, 2.0 * clips.shape[0] * T * crop * crop,
                                   F32_OPS)
        k9.append(dict(
            case=f"({batch},{T},{raw},{raw}) -> ({batch},{T},5,{crop},{crop})",
            dtype=dtype_name(got), max_abs_err=0.0, vs_two_pass=diff,
            ms=ms_of(lambda: ops.stack_frames_u8(clips, crop, dt)),
            plain_ms=ms_of(lambda: ops.stack_frames_u8_plain(clips, crop, dt)),
            module_ms=ms_of(lambda: ops.stack_frames(device_ingest(clips, crop, dt))),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library_call="none: no single PyTorch call crops, normalizes and "
            "stacks; module_ms is device_ingest + K2"))
        del got
    del clips
    torch.cuda.empty_cache()
    for r in k9:
        print(f"phase 3d stack_frames_u8 {r['case']} {r['dtype']}: bit-exact; vs "
              f"device_ingest + K2 max abs diff {r['vs_two_pass']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, device_ingest + K2 "
              f"{r['module_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # ---- K10 on the eligible blocks' shapes
    k10 = []
    for dt, n in ((torch.bfloat16, frames), (torch.float32,
                                             min(frames, RESBLOCK_F32_FRAMES))):
        name_dt = str(dt).split(".")[-1]
        extra = RESBLOCK_REGISTER_SHAPES if dt == torch.bfloat16 else ()
        for name, C_, S, per_batch in RESBLOCK_SHAPES + extra:
            block = BasicBlock(C_, C_, 1, cfg.frontend.bn_epsilon, dt).to(dev).eval()
            with torch.no_grad():
                for conv in (block.conv1, block.conv2):
                    conv.weight.copy_(torch.randn(conv.weight.shape, generator=g,
                                                  device=dev) * (2.0 / (9 * C_)) ** 0.5)
                for bn in (block.bn1, block.bn2):
                    bn.weight.copy_(1.0 + 0.1 * torch.randn(C_, generator=g, device=dev))
                    bn.bias.copy_(0.1 * torch.randn(C_, generator=g, device=dev))
                    bn.running_mean.copy_(0.1 * torch.randn(C_, generator=g, device=dev))
                    bn.running_var.copy_(1.0 + 0.2 * torch.rand(C_, generator=g, device=dev))
            x = torch.relu(torch.randn((n, C_, S, S), generator=g, device=dev)).to(dt)
            with torch.inference_mode():
                a1, b1 = ops.fold_bn(block.bn1.weight, block.bn1.bias,
                                     block.bn1.running_mean, block.bn1.running_var,
                                     block.bn_epsilon)
                a2, b2 = ops.fold_bn(block.bn2.weight, block.bn2.bias,
                                     block.bn2.running_mean, block.bn2.running_var,
                                     block.bn_epsilon)
                args = (x, block.conv1.weight.to(dt), a1, b1,
                        block.conv2.weight.to(dt), a2, b2)
                got = ops.fused_resblock(*args)
                want = ops.fused_resblock_plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                top = want.float().abs().max().item()
                if dt == torch.float32:
                    ok = err.max().item() <= RESBLOCK_TOL["float32"] * top
                else:
                    tol = RESBLOCK_TOL["bfloat16"]
                    ok = bool((err <= want.float().abs() * tol["rel"]
                               + top * tol["floor"]).all())
                max_err = err.max().item()
                check(ok and bool(torch.isfinite(got).all()),
                      f"K10 {name} {name_dt}: max abs err {max_err} (largest "
                      f"element {top})")
                module = block(x)
                module_diff = (got.float() - module.float()).abs().max().item()
                del got, want, err, module
                flops = 2 * 2.0 * n * S * S * 9 * C_ * C_
                n_bytes = (2 * x.numel() + 2 * 9 * C_ * C_) * x.element_size() + 16 * C_
                bound_ms, bound_by = bound(
                    n_bytes, flops, BF16_FLOPS if dt == torch.bfloat16 else F32_OPS)
                timed = timing and dt == torch.bfloat16 and per_batch > 0
                k10.append(dict(
                    case=f"{name} ({n},{C_},{S},{S})", dtype=name_dt,
                    per_batch=per_batch, max_abs_err=max_err, largest=top,
                    vs_module=module_diff,
                    ms=cuda_ms(torch, lambda: ops.fused_resblock(*args)) if timed else None,
                    plain_ms=cuda_ms(torch, lambda: ops.fused_resblock_plain(*args))
                    if timed else None,
                    module_ms=cuda_ms(torch, lambda: block(x)) if timed else None,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    library_call="none: no single PyTorch call computes the block; "
                    "module_ms is the BasicBlock's cuDNN composition"))
            del x, block, args
            torch.cuda.empty_cache()
    for r in k10:
        times = ("not timed" if r["ms"] is None else
                 f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, module "
                 f"(cuDNN) {r['module_ms']:.3f} ms")
        print(f"phase 3d fused_resblock {r['case']} {r['dtype']}: max abs err "
              f"{r['max_abs_err']:.3g} (largest element {r['largest']:.3g}), vs "
              f"module {r['vs_module']:.3g}; {times}, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
    timed16 = [r for r in k10 if r["ms"] is not None]
    if timed16:
        print("phase 3d fused_resblock per path-A batch (bf16, 5 launches): kernel "
              + ", ".join(f"{what} {sum(r[key] * r['per_batch'] for r in timed16):.3f} ms"
                          for what, key in (("", "ms"), ("module (cuDNN)", "module_ms"),
                                            ("bound", "bound_ms"))).lstrip(" ,"))

    # ---- K11 at the decode loop's narrowest and widest segment
    k11 = []
    Tk = T
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        layer, d = _layer_for_check(torch, dev, dt, 11)
        D, H, DI = d.d_model, d.n_head, d.d_inner
        for L in (3, 17):
            x = torch.randn((2, batch, L, D), generator=g, device=dev).to(dt)
            ck = torch.randn((2, batch, Tk, D), generator=g, device=dev).to(dt)
            cv = torch.randn((2, batch, Tk, D), generator=g, device=dev).to(dt)
            causal = ops.mask_to_bias(
                torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)[None], L, L)
            for bias in (None, causal):
                with torch.inference_mode():
                    args = (x, *layer_params_to_args(layer), ck, cv, H)
                    mb = None if bias is None else bias[0]
                    got = ops.fused_decoder_layer(*args, mask_bias=mb)
                    want = ops.fused_decoder_layer_plain(*args, mask_bias=mb)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    check(err <= LAYER_TOL[name_dt] and bool(torch.isfinite(got).all()),
                          f"K11 L={L} bias={bias is not None} {name_dt}: max abs err "
                          f"{err} > {LAYER_TOL[name_dt]}")
                    layer.use_fused_layer = False
                    module = layer(x, ck, cv, bias)
                    layer.use_fused_layer = True
                    module_diff = (got.float() - module.float()).abs().max().item()
                    del got, want, module
                    rows_ = 2.0 * batch * L
                    flops = (2 * rows_ * (6 * D * D + 2 * D * DI)
                             + 2 * 2 * rows_ * D * (L + Tk))
                    n_bytes = ((2 * x.numel() + 2 * ck.numel()
                                + 2 * (6 * D * D + 2 * D * DI)) * x.element_size()
                               + 2 * 4 * (13 * D + DI))
                    bound_ms, bound_by = bound(
                        n_bytes, flops, BF16_FLOPS if dt == torch.bfloat16 else F32_OPS)

                    def module_call():
                        layer.use_fused_layer = False
                        out = layer(x, ck, cv, bias)
                        layer.use_fused_layer = True
                        return out
                    k11.append(dict(
                        case=f"L={L} {'causal bias' if bias is not None else 'no bias'} "
                        f"(2,{batch},{L},{D})", dtype=name_dt, max_abs_err=err,
                        vs_module=module_diff,
                        ms=ms_of(lambda: ops.fused_decoder_layer(*args, mask_bias=mb)),
                        plain_ms=ms_of(lambda: ops.fused_decoder_layer_plain(
                            *args, mask_bias=mb)),
                        module_ms=ms_of(module_call),
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        library_call="none: no single PyTorch call computes the "
                        "layer; module_ms is the _SBLLayer composition (cuBLAS "
                        "+ K1)"))
            del x, ck, cv
        del layer
        torch.cuda.empty_cache()
    # a head width above the GEMM tile's 64 columns (d_k = 128, 4 heads):
    # the head projections run in two column tiles
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        layer, d = _layer_for_check(torch, dev, dt, 12, n_head=4)
        L = 17
        x = torch.randn((2, 64, L, d.d_model), generator=g, device=dev).to(dt)
        ck = torch.randn((2, 64, Tk, d.d_model), generator=g, device=dev).to(dt)
        causal = ops.mask_to_bias(
            torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)[None], L, L)[0]
        with torch.inference_mode():
            args = (x, *layer_params_to_args(layer), ck, ck.flip(-1).contiguous(),
                    d.n_head)
            got = ops.fused_decoder_layer(*args, mask_bias=causal)
            want = ops.fused_decoder_layer_plain(*args, mask_bias=causal)
        err = (got.float() - want.float()).abs().max().item()
        print(f"phase 3d fused_decoder_layer d_k=128 L={L} causal bias "
              f"(2,64,{L},{d.d_model}) {name_dt}: max abs err {err:.3g} (tol "
              f"{LAYER_TOL[name_dt]})")
        check(err <= LAYER_TOL[name_dt] and bool(torch.isfinite(got).all()),
              f"K11 d_k=128 {name_dt}: max abs err {err}")
        del layer, x, ck, got, want
    # d_model 40, 2 heads of 20, bf16: no TMA map (its boxes need d_model a
    # multiple of 16), so the ring fills its stages through registers; a
    # cluster of 2; x staged by 16-byte copies, cross K/V (d_k not a
    # multiple of 8) element by element
    layer, d = _layer_for_check(torch, dev, torch.bfloat16, 13, n_head=2, d_model=40)
    L = 17
    x = torch.randn((2, 64, L, d.d_model), generator=g, device=dev).to(torch.bfloat16)
    ck = torch.randn((2, 64, Tk, d.d_model), generator=g, device=dev).to(torch.bfloat16)
    causal = ops.mask_to_bias(
        torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)[None], L, L)[0]
    with torch.inference_mode():
        args = (x, *layer_params_to_args(layer), ck, ck.flip(-1).contiguous(), d.n_head)
        got = ops.fused_decoder_layer(*args, mask_bias=causal)
        want = ops.fused_decoder_layer_plain(*args, mask_bias=causal)
    err = (got.float() - want.float()).abs().max().item()
    print(f"phase 3d fused_decoder_layer weights through registers: d_model "
          f"{d.d_model}, d_k={d.d_k}, L={L} causal bias (2,64,{L},{d.d_model}) "
          f"bfloat16: max abs err {err:.3g} (tol {LAYER_TOL['bfloat16']})")
    check(err <= LAYER_TOL["bfloat16"] and bool(torch.isfinite(got).all()),
          f"K11 d_model={d.d_model} bfloat16: max abs err {err}")
    del layer, x, ck, got, want
    for r in k11:
        print(f"phase 3d fused_decoder_layer {r['case']} {r['dtype']}: max abs err "
              f"{r['max_abs_err']:.3g} (tol {LAYER_TOL[r['dtype']]}), vs module path "
              f"{r['vs_module']:.3g}; kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, module {r['module_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return k9, k10, k11


def phase_path_a(torch, np, dev):
    """Path A: sbl recognize with both eval-side switches on and K9 as the
    ingest, at the full width."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
        cast_dense_weights)
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        Recognition, expected_launches, recognize_batch)

    base = C.sbl()
    cfg = dataclasses.replace(base, use_fused_decoder_layer=True)
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    V, maxlen = cfg.decoder.vocab_size, cfg.decoder.maxlen
    rng = np.random.default_rng(8)

    def clips(batch):
        return torch.from_numpy(rng.integers(0, 256, size=(batch, T, raw, raw),
                                             dtype=np.uint8)).to(dev)

    def recognize_stacked(model, clips_u8):
        """recognize_batch with K9 in place of device_ingest + K2."""
        model.eval()
        with torch.inference_mode(), cast_dense_weights(model):
            xs = ops.stack_frames_u8(clips_u8, crop, model.frontend.dtype)
            feats = model.frontend.forward_stacked(xs)
            return Recognition(*model.decoder.decode(model.encoder(feats)))

    on = build_model(cfg, dev, seed=0, use_pallas_resblock=True)
    off = build_model(base, dev, seed=0)

    small = clips(SWITCH_CHECK_BATCH)
    a = recognize_stacked(on, small)
    b = recognize_batch(on, small, crop)
    c = recognize_batch(off, small, crop)
    torch.cuda.synchronize()
    check(torch.equal(a.logits_l2r, b.logits_l2r) and torch.equal(a.ys_r2l, b.ys_r2l),
          "K9 as the ingest changes recognize's output")
    first = max((a.logits_l2r[:, 0] - c.logits_l2r[:, 0]).abs().max().item(),
                (a.logits_r2l[:, 0] - c.logits_r2l[:, 0]).abs().max().item())
    agree = torch.cat([(a.ys_l2r == c.ys_l2r)[:, 1:],
                       (a.ys_r2l == c.ys_r2l)[:, 1:]]).float().mean().item()
    print(f"phase 7 bf16 B={SWITCH_CHECK_BATCH} switches on vs off: K9 ingest == "
          f"device_ingest + K2 (bit-identical logits); first-step logits max abs "
          f"diff {first:.3g} (tol {SWITCH_LOGIT_TOL}), token agreement {agree:.4f} "
          f"(min {SWITCH_MIN_AGREEMENT})")
    check(first <= SWITCH_LOGIT_TOL, f"first-step logits differ by {first}")
    check(agree >= SWITCH_MIN_AGREEMENT, f"tokens agree only {agree}")

    batch = clips(SLICE_BATCH)
    recognize_stacked(on, batch)                 # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = recognize_stacked(on, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = dict(expected_launches(cfg, use_pallas_resblock=True),
                    stack_frames=0, stack_frames_u8=1)
    print(f"phase 7 bf16 B={SLICE_BATCH} launches per batch: {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    check((launches["stack_frames_u8"], launches["fused_resblock"],
           launches["fused_decoder_layer"], launches["small_mha_flat"])
          == (1, 5, 96, 6), f"path A launches {launches}")
    for ys in (out.ys_l2r, out.ys_r2l):
        check(tuple(ys.shape) == (SLICE_BATCH, maxlen + 1), "tokens shape")
        check(int(ys.min()) >= 0 and int(ys.max()) < V, "token out of range")
    for lg in (out.logits_l2r, out.logits_r2l):
        check(tuple(lg.shape) == (SLICE_BATCH, maxlen, V), "logits shape")
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
    del on, off
    torch.cuda.empty_cache()
    return launches, dict(first_step_logit_diff=first, token_agreement=agree)


def phase_path_b(torch, np, dev):
    """Path B: lrw1000 / lrw evaluation and the sbl beam through `cli test`."""
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
    from sbl_for_multilingual_lip_reading_tpu_torch.decode import (
        bigram_from_dataset, make_uni_beam_decoder)
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches, recognize_batch)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    results = {}
    launches = None
    k13_counts = {}
    for workload, preset, runs in (
            ("lrw1000", C.lrw1000_seq2seq, ([], ["--beam-size", str(UNI_BEAM),
                                                 "--bigram-lm"])),
            ("lrw", C.lrw_seq2seq, ([],)),
            ("sbl", C.sbl, (["--beam-size", str(UNI_BEAM)],))):
        cfg = preset()
        B = cfg.batch_size
        common = ["--workload", workload, "--synthetic", "--synthetic-size",
                  str(4 * B), "--max-eval-batches", "1"]
        path = str(CKPT_DIR / workload)
        model = build_model(cfg, dev, seed=0)
        tr = Trainer(cfg, [], {}, model=model)
        tr.save(path)
        args = cli.build_argparser().parse_args(common)
        train_ds, test_sets = cli.make_datasets(cfg, args, "test")
        for extra in runs:
            beam = UNI_BEAM if extra else None
            big = None
            if "--bigram-lm" in extra:
                big = np.log(bigram_from_dataset(train_ds, cfg.decoder.vocab_size)
                             + np.float32(1e-10))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            ops.cached_attention_step.launches = 0
            got = cli.run_test(common + ["--checkpoint", path] + extra)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            k13_launches = ops.cached_attention_step.launches
            want = {k: tr.validate_seq2seq(ds, 1, beam_size=beam, bigram_logp=big)
                    for k, ds in test_sets.items()}
            check(got == want, f"cli test {workload} {extra}: {got} != in-memory "
                  f"model {want}")
            for scores in got.values():
                check(all(np.isfinite(v) for v in scores.values()),
                      f"non-finite score in {scores}")
            label = " ".join(extra) if extra else "greedy"
            print(f"phase 8 cli test --workload {workload} {label} (B={B}, "
                  f"{len(test_sets)} eval set(s)): {got}, equal to the in-memory "
                  f"model's")
            results[f"{workload} {label}"] = got
            if workload == "lrw1000":
                # K13: a launch a decoder layer and step of each eval batch
                want13 = cfg.dims.n_dec_layers * cfg.decoder.maxlen * len(test_sets)
                print(f"phase 8 lrw1000 {label} K13 launches: {k13_launches} "
                      f"(expected {want13})")
                check(k13_launches == want13, f"K13 launches {k13_launches} != {want13}")
                k13_counts[label] = k13_launches
            if workload == "lrw1000" and not extra:
                launches = counts
                expected = {k: v * len(test_sets)
                            for k, v in expected_launches(cfg).items()}
                print(f"phase 8 lrw1000 greedy launches: {launches} (expected "
                      f"{expected})")
                check(launches == expected, f"launch counts {launches} != {expected}")
        if workload == "lrw1000":
            # beam 1 == greedy, and beam 5's scores, on one resident batch
            T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
            clips = torch.from_numpy(np.random.default_rng(9).integers(
                0, 256, size=(B, T, raw, raw), dtype=np.uint8)).to(dev)
            video = device_ingest(clips, crop, model.frontend.dtype)
            greedy = recognize_batch(model, clips, crop)
            tokens1, _ = make_uni_beam_decoder(model, 1)(video)
            check(torch.equal(tokens1[:, 0], greedy), "beam 1 != greedy tokens")
            beam5 = make_uni_beam_decoder(model, UNI_BEAM)
            tokens5, scores5 = beam5(video)
            check(bool(torch.isfinite(scores5).all())
                  and bool((scores5[:, :-1] >= scores5[:, 1:]).all()),
                  "beam scores not finite and sorted")
            print(f"phase 8 lrw1000 bf16 B={B}: beam 1 == greedy tokens; beam "
                  f"{UNI_BEAM}'s scores finite and sorted")
            del clips, video
        del model, tr
        torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    results["k13_launches"] = k13_counts
    return launches, results


def phase_path_c(torch, np, dev):
    """Path C: lrw1000 (and lrw) training at the full width, bf16."""
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches as eval_launches)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches, make_uni_train_step)

    cfg = C.lrw1000_seq2seq()
    B = cfg.batch_size
    data = SyntheticLipDataset(size=B, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, kind="lrw1000",
                               vocab="lrw1000", seed=0)
    kernel_vs_plain_step(torch, dev, cfg, train_batch(
        torch, np, dev, cfg, data, TRAIN_CHECK_BATCH, 1), "phase 9 lrw1000")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    path = str(CKPT_DIR / "lrw1000")
    common = ["--workload", "lrw1000", "--synthetic", "--synthetic-size",
              str(ENTRY_STEPS * B), "--max-eval-batches", "1"]
    tr, out, launches = _cli_train(torch, cli, ops, common + [
        "--epochs", "1", "--max-steps-per-epoch", str(ENTRY_STEPS),
        "--save-dir", path])
    n_eval = len(tr.valid_datasets)
    per_step = expected_launches(cfg)
    expected = {k: ENTRY_STEPS * per_step[k] + n_eval * v
                for k, v in eval_launches(cfg).items()}
    print(f"phase 9 cli train --workload lrw1000: {ENTRY_STEPS} steps of B={B} and "
          f"{n_eval} eval batch(es); launches {launches} "
          f"(expected {expected}; per step {per_step})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    check((per_step["small_mha_dropout_fwd_flat"], per_step["small_mha_dropout_bwd_flat"])
          == (cfg.dims.n_enc_layers + 2 * cfg.dims.n_dec_layers,) * 2,
          f"per-step K3/K4 launches {per_step}")
    check(np.isfinite(out["train_loss"]) and tr.state.step == ENTRY_STEPS,
          f"lrw1000 training: loss {out['train_loss']}, step {tr.state.step}")
    got = cli.run_test(common + ["--checkpoint", path])
    _, test_sets = cli.make_datasets(tr.cfg, cli.build_argparser().parse_args(
        common), "test")
    want = {k: tr.validate_seq2seq(ds, 1) for k, ds in test_sets.items()}
    check(got == want, f"cli test lrw1000 {got} != in-memory model {want}")
    print(f"phase 9 cli train --workload lrw1000: loss {out['train_loss']:.4f}; "
          f"cli test {got}, equal to the in-memory model's")
    del tr
    torch.cuda.empty_cache()

    lrw, lrw_out, _ = _cli_train(torch, cli, ops, [
        "--workload", "lrw", "--synthetic", "--synthetic-size",
        str(C.lrw_seq2seq().batch_size), "--max-eval-batches", "1", "--epochs",
        "1", "--max-steps-per-epoch", "1", "--save-dir", str(CKPT_DIR / "lrw")])
    check(np.isfinite(lrw_out["train_loss"]) and lrw.state.step == 1,
          f"lrw training: loss {lrw_out['train_loss']}")
    print(f"phase 9 cli train --workload lrw: 1 step, loss "
          f"{lrw_out['train_loss']:.4f}, eval {lrw_out['lrw']}")
    del lrw
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    model = build_model(cfg, dev, seed=0)
    step = make_uni_train_step(model, make_optimizer(model, cfg.optim), cfg)
    steps = run_train_steps(torch, np, step, train_batch(
        torch, np, dev, cfg, data, B, 2), B, "phase 9 lrw1000")
    del model, step
    torch.cuda.empty_cache()
    return launches, dict(loss=out["train_loss"], eval=out,
                          per_step_launches=per_step, **steps)


def phase_path_d(torch, np, dev):
    """Path D: classify at the full width, bf16, B=120; then the recipe."""
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training import checkpoint
    from sbl_for_multilingual_lip_reading_tpu_torch.training.recipe import (
        run_three_stage_recipe)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches, make_classify_train_step)

    cfg = C.classify()
    B, T, raw = cfg.batch_size, cfg.data.frames, cfg.data.raw_size
    data = SyntheticLipDataset(size=B, frames=T, raw_size=raw, seed=0)
    kernel_vs_plain_step(torch, dev, cfg, train_batch(
        torch, np, dev, cfg, data, TRAIN_CHECK_BATCH, 1), "phase 10 classify")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    path = str(CKPT_DIR / "classify")
    common = ["--workload", "classify", "--synthetic", "--synthetic-size",
              str(ENTRY_STEPS * B), "--max-eval-batches", "1"]
    tr, out, launches = _cli_train(torch, cli, ops, common + [
        "--epochs", "1", "--max-steps-per-epoch", str(ENTRY_STEPS),
        "--save-dir", path])
    n_eval = len(tr.valid_datasets)
    per_step = expected_launches(cfg)
    # an eval batch: the frame stack and one attention per encoder layer
    per_eval = dict(dict.fromkeys(per_step, 0), stack_frames=1,
                    small_mha_flat=cfg.dims.n_enc_layers)
    expected = {k: ENTRY_STEPS * per_step[k] + n_eval * per_eval[k]
                for k in per_step}
    print(f"phase 10 cli train --workload classify: {ENTRY_STEPS} steps of B={B} "
          f"and {n_eval} eval batch(es); launches {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    check(np.isfinite(out["train_loss"]) and tr.state.step == ENTRY_STEPS,
          f"classify training: loss {out['train_loss']}, step {tr.state.step}")
    got = cli.run_test(common + ["--checkpoint", path])
    _, test_sets = cli.make_datasets(tr.cfg, cli.build_argparser().parse_args(
        common), "test")
    want = {k: tr.validate_classify(ds, 1) for k, ds in test_sets.items()}
    check(got == want, f"cli test classify {got} != in-memory model {want}")
    print(f"phase 10 cli train --workload classify: loss {out['train_loss']:.4f}; "
          f"cli test {got}, equal to the in-memory model's")
    del tr
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    model = build_model(cfg, dev, seed=0)
    step = make_classify_train_step(model, make_optimizer(model, cfg.optim), cfg)
    steps = run_train_steps(torch, np, step, train_batch(
        torch, np, dev, cfg, data, B, 2), B, "phase 10 classify")
    del model, step
    torch.cuda.empty_cache()

    # the three-stage recipe at the full width and depth, one step a stage
    sbl = C.sbl()
    records = run_three_stage_recipe(
        cfg, sbl, SyntheticLipDataset(size=B, frames=T, raw_size=raw, seed=1),
        SyntheticLipDataset(size=sbl.batch_size, frames=sbl.data.frames,
                            raw_size=raw, seed=2),
        SyntheticLipDataset(size=sbl.batch_size, frames=sbl.data.frames,
                            raw_size=raw, seed=3),
        str(CKPT_DIR / "recipe"), classify_steps=1, stage_steps=1,
        max_eval_batches=1, device=dev)
    torch.cuda.synchronize()
    stage1 = checkpoint.load(str(CKPT_DIR / "recipe" / "stage1_classify"))["model"]
    frozen = [k for k in stage1 if k.startswith(("frontend.", "encoder."))
              and "running" not in k]
    stages = [checkpoint.load(str(CKPT_DIR / "recipe" / r["stage"]))["model"]
              for r in records[1:]]
    check([r["stage"] for r in records] == ["classify", "stage2_tf05_frozen",
                                            "stage2_tf01_frozen", "stage3_finetune"],
          f"recipe stages {[r['stage'] for r in records]}")
    check(all(np.isfinite(r["loss"]) for r in records), "recipe: non-finite loss")
    check(records[1]["transferred"] == len(frozen),
          f"transferred {records[1]['transferred']} != {len(frozen)} frontend and "
          f"encoder parameters in the classify checkpoint")
    for k in frozen:
        check(torch.equal(stages[0][k], stage1[k]) and torch.equal(stages[1][k],
                                                                   stage1[k]),
              f"recipe: frozen {k} moved in stage 2")
    check(any(not torch.equal(stages[2][k], stage1[k]) for k in frozen),
          "recipe: the finetune moved no frontend or encoder parameter")
    summary = [{k: r[k] for k in ("stage", "loss", "wer", "transferred") if k in r}
               for r in records]
    print(f"phase 10 recipe (full width and depth, 1 step a stage): "
          f"{summary}; {len(frozen)} frozen tensors bit-identical through "
          f"stage 2")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, dict(loss=out["train_loss"], eval=out,
                          per_step_launches=per_step, recipe=summary, **steps)


# ---------------------------------------------------------------------------
# path E: the data-parallel, rematerialised training path
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _step_record(torch, step, batch, seed=5, **kw):
    """One step: (loss, {name: gradient}, {name: running statistic}), the
    tensors left on the card."""
    model = step.state.model
    loss = step(batch, torch.Generator().manual_seed(seed), **kw)["loss"].item()
    return (loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()
             if "running" in n})


def _compare_steps(label, dtype, got, want):
    """Loss, gradients and running statistics of two steps within phase 5's
    tolerances; returns the errors."""
    (lg, gg, sg), (lw, gw, sw) = got, want
    errs = _grad_errors(gg, gw)
    worst = max(errs, key=errs.get)
    bn_err = max((sg[n] - b).abs().max().item() for n, b in sw.items())
    print(f"{label} {dtype}: loss {lg:.6f} vs {lw:.6f} (tol "
          f"{TRAIN_LOSS_TOL[dtype]}); gradient rel err max {errs[worst]:.3g} at "
          f"{worst} (tol {TRAIN_GRAD_TOL[dtype]}); BN running stats max abs diff "
          f"{bn_err:.3g} (tol {TRAIN_BN_TOL[dtype]})")
    check(abs(lg - lw) <= TRAIN_LOSS_TOL[dtype], f"{label} {dtype}: losses differ")
    check(errs[worst] <= TRAIN_GRAD_TOL[dtype],
          f"{label} {dtype}: gradient of {worst} differs by {errs[worst]}")
    check(bn_err <= TRAIN_BN_TOL[dtype], f"{label} {dtype}: BN stats differ")
    return dict(loss_err=abs(lg - lw), grad_err=errs[worst], bn_err=bn_err)


def _path_e_setup(torch, np, dev, n):
    """The sbl config, and the first shuffled batch of ``n`` with its plans
    on the card."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    cfg = C.sbl()
    data = SyntheticLipDataset(size=n, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=4)
    return cfg, train_batch(torch, np, dev, cfg, data, n, 6)


def _new_step(torch, dev, cfg, mesh=None, shard=False):
    """The train step of a model built from seed 0 (with ``shard``, cut to
    this process's slice over ``mesh``'s model group)."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import shard_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        make_train_step)
    model = build_model(cfg, dev, seed=0)
    if shard:
        shard_model(model, mesh)
    return make_train_step(model, make_optimizer(model, cfg.optim), cfg, mesh)


def phase_remat(torch, np, dev):
    """E1: remat_frontend on vs off at B=TRAIN_CHECK_BATCH with PALLAS_BN=1,
    f32 and bf16 (loss, gradients, running statistics within phase 5's
    tolerances; the statistics moved once; K7 launched once more per
    recomputed BatchNorm); then the bf16 B=240 step, remat on and off."""
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches)
    _set_switches(True)
    cfg, small = _path_e_setup(torch, np, dev, TRAIN_CHECK_BATCH)
    out, k7 = {}, {}
    for dtype in ("float32", "bfloat16"):
        runs = []
        for remat in (False, True):
            c = dataclasses.replace(cfg, compute_dtype=dtype, remat_frontend=remat)
            step = _new_step(torch, dev, c)
            init = {n: b.clone() for n, b in step.state.model.named_buffers()
                    if "running" in n}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            rec = _step_record(torch, step, small)
            torch.cuda.synchronize()
            counts, want = ops.launch_counts(), expected_launches(c)
            check(counts == want, f"E1 remat={remat} {dtype}: launches {counts} "
                  f"!= {want}")
            k7[remat] = (counts["channel_sums"], counts["channel_sums_pair"])
            check(all(not torch.equal(rec[2][n], b) for n, b in init.items()
                      if n.endswith("running_mean")),
                  f"E1 remat={remat} {dtype}: running statistics did not move")
            runs.append(rec)
            del step
        out[dtype] = _compare_steps("phase E1 remat on vs off", dtype, runs[1],
                                    runs[0])
        del runs
        torch.cuda.empty_cache()
    out["k7_k8_launches"] = {"remat_off": k7[False], "remat_on": k7[True]}
    print(f"phase E1 (K7, K8) launches a step: remat off {k7[False]}, remat on "
          f"{k7[True]}; the running statistics moved once in both")
    cfg, batch = _path_e_setup(torch, np, dev, TRAIN_BATCH)
    for remat in (False, True):
        step = _new_step(torch, dev, dataclasses.replace(cfg, remat_frontend=remat))
        out[f"b240_remat_{'on' if remat else 'off'}"] = run_train_steps(
            torch, np, step, batch, TRAIN_BATCH,
            f"phase E1 PALLAS_BN=1 remat {'on' if remat else 'off'}")
        del step
        torch.cuda.empty_cache()
    _set_switches(False)
    return out


def phase_grad_clip(torch, np, dev):
    """E2: a step with grad_clip set against optax's clip_by_global_norm
    applied by hand to the same step's unclipped gradients (f32)."""
    cfg, small = _path_e_setup(torch, np, dev, TRAIN_CHECK_BATCH)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    _, raw, _ = _step_record(torch, _new_step(torch, dev, cfg), small)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in raw.values())).item()
    max_norm = 0.5 * norm
    clipped = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_clip=max_norm))
    _, got, _ = _step_record(torch, _new_step(torch, dev, clipped), small)
    want = {n: g / norm * max_norm for n, g in raw.items()}
    errs = _grad_errors(got, want)
    worst = max(errs, key=errs.get)
    print(f"phase E2 grad_clip {max_norm:.4g} (half the global norm {norm:.4g}): "
          f"clipped gradients vs optax's rule by hand, rel err max "
          f"{errs[worst]:.3g} at {worst} (tol {TRAIN_GRAD_TOL['float32']})")
    check(errs[worst] <= TRAIN_GRAD_TOL["float32"], "E2: clipped gradients differ")
    del raw, got, want
    torch.cuda.empty_cache()
    return dict(norm=norm, grad_err=errs[worst])


def phase_dp_one(torch, np, dev):
    """E3: the data-parallel step at W = 1 under NCCL (the all-reduces of
    the gradients, of the BatchNorm sums of K7 and K8, and of the loss's
    counts) against the plain step, f32, PALLAS_BN=1, remat on."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    _set_switches(True)
    cfg, small = _path_e_setup(torch, np, dev, TRAIN_CHECK_BATCH)
    cfg = dataclasses.replace(cfg, compute_dtype="float32", remat_frontend=True)
    want = _step_record(torch, _new_step(torch, dev, cfg), small)
    mesh = make_mesh(1, device=dev, init_method=f"tcp://localhost:{_free_port()}")
    check(mesh.backend == "nccl", f"E3: backend {mesh.backend}")
    try:
        got = _step_record(torch, _new_step(
            torch, dev, dataclasses.replace(cfg, mesh=C.MeshConfig(data=1)), mesh),
            small)
    finally:
        shutdown()
    out = _compare_steps("phase E3 W=1 NCCL dp step vs plain step", "float32",
                         got, want)
    _set_switches(False)
    del got, want
    torch.cuda.empty_cache()
    return out


def _dp_config(cfg):
    """Phase E4's step: f32 (TF32 off), remat on, dropout on."""
    return dataclasses.replace(cfg, compute_dtype="float32", remat_frontend=True)


# phase E4's teacher forcing: gold at every decode step (the coins are the
# same in every process anyway); a free-running step feeds the argmax of
# logits that random weights leave nearly tied, and a tie broken otherwise by
# the two runs' last bits changes the rest of that sample's decode
DP_USE_GOLD = [True] * 16


def dp_worker(torch, np, dev, rank: int, port: int, outdir: str) -> int:
    """One process of phase E4: its half of the B=240 batch (``_dp_config``,
    PALLAS_BN=1), synchronised BatchNorm then per process; one checked step
    each."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    _set_switches(True)
    mesh = make_mesh(DP_WORLD, device=dev, rank=rank, backend="gloo",
                     init_method=f"tcp://localhost:{port}")
    cfg, batch = _path_e_setup(torch, np, dev, TRAIN_BATCH)
    n = TRAIN_BATCH // DP_WORLD
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    out = {}
    for sync in (True, False):
        c = dataclasses.replace(_dp_config(cfg), mesh=C.MeshConfig(
            data=DP_WORLD, sync_batchnorm=sync))
        step = _new_step(torch, dev, c, mesh)
        loss, grads, stats = _step_record(torch, step, local,
                                          use_gold=DP_USE_GOLD)
        out[sync] = dict(
            loss=loss, stats={k: v.cpu() for k, v in stats.items()},
            grads=({k: v.cpu() for k, v in grads.items()} if rank == 0 and sync
                   else None),
            grad_norms={k: v.float().norm().item() for k, v in grads.items()})
        del step, grads
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    shutdown()
    return 0


def phase_dp_two(torch, np, dev):
    """E4: W = 2 processes on the one card over gloo: each its half of the
    B=240 batch (f32, PALLAS_BN=1, remat on, dropout on, gold fed at every
    decode step); the step against the one-process step on the whole batch
    (loss, gradients, running statistics within phase 5's f32
    tolerances), and with per-process BatchNorm the kept running
    statistics against local BatchNorm on process 0's half."""
    import tempfile

    def on_host(rec):
        return (rec[0], {k: v.cpu() for k, v in rec[1].items()},
                {k: v.cpu() for k, v in rec[2].items()})
    # the one-process step's own f32 rounding floor: the same step with the
    # plain BatchNorm (torch's reductions in place of K7/K8)
    _set_switches(False)
    cfg, batch = _path_e_setup(torch, np, dev, TRAIN_BATCH)
    cfg = _dp_config(cfg)
    alt = on_host(_step_record(torch, _new_step(torch, dev, cfg), batch,
                               use_gold=DP_USE_GOLD))
    _set_switches(True)
    want = on_host(_step_record(torch, _new_step(torch, dev, cfg), batch,
                                use_gold=DP_USE_GOLD))
    half = {k: v[:TRAIN_BATCH // DP_WORLD] for k, v in batch.items()}
    local = _step_record(torch, _new_step(torch, dev, cfg), half,
                         use_gold=DP_USE_GOLD)
    local_stats = {k: v.cpu() for k, v in local[2].items()}
    del local, batch, half
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-worker",
             str(r), str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(DP_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"E4 process {r} failed:\n{log[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    sync0 = ranks[0][True]
    out = _compare_dp_step((sync0["loss"], sync0["grads"], sync0["stats"]),
                           want, alt)
    for r in ranks[1:]:
        check(r[True]["loss"] == sync0["loss"], "E4: the processes' losses differ")
        check(r[True]["grad_norms"] == sync0["grad_norms"],
              "E4: the processes' averaged gradients differ")
    for r in ranks:
        err = max((r[False]["stats"][k] - v).abs().max().item()
                  for k, v in local_stats.items())
        check(err <= TRAIN_BN_TOL["float32"],
              f"E4 no-sync: kept running statistics differ by {err}")
    print(f"phase E4 no-sync: every process keeps process 0's running "
          f"statistics, within {err:.3g} of local BatchNorm on its half")
    _set_switches(False)
    return out


# phase E7's grids: (name, data, model, compute dtypes), each one launch of
# data x model processes; E8's grid is (1, 2)
TP_GRIDS = (("model2", 1, 2, ("float32", "bfloat16")),
            ("data2 x model2", 2, 2, ("float32",)))
# E7's bf16 turn against the one-process bf16 step.  f32 takes phase 5's
# f32 tolerances; in bf16 the row-parallel products are summed in f32 and
# rounded once where the one-process GEMM rounds once too, but every bf16
# rounding after them may land one ulp apart, as phase 5's kernel vs plain
# bf16 steps do: phase 5's bf16 tolerances
TP_BF16_TOL = {"loss": TRAIN_LOSS_TOL["bfloat16"], "grad": TRAIN_GRAD_TOL["bfloat16"],
               "bn": TRAIN_BN_TOL["bfloat16"]}
E8_BATCH = 8
# E8's greedy tokens at model = 1 against the tensor-parallel eval's: equal,
# but where the one-process logits of the first differing step put the two
# tokens within TIE_TOL of each other (a tie the two f32 encoders' last bits
# break either way)
TIE_TOL = 1e-4


def tp_worker(torch, np, dev, phase: str, rank: int, port: int,
              outdir: str) -> int:
    """One process of phase E7 (``phase`` "E7-<turn index>") or E8 on the
    one card over gloo: the grid's step against what phase E7's parent
    compares it with, or E8's Trainer."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        gather_state_dict, make_mesh, shutdown)
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel.tensor import (
        gather_from_model)
    if phase == "E8":
        return _e8_worker(torch, np, dev, rank, port, outdir)
    name, data, model, dtypes = TP_GRIDS[int(phase.split("-")[1])]
    _set_switches(True)
    mesh = make_mesh(data, model, device=dev, rank=rank, backend="gloo",
                     init_method=f"tcp://localhost:{port}")
    cfg0, batch = _path_e_setup(torch, np, dev, TRAIN_BATCH)
    n = TRAIN_BATCH // data
    local = {k: v[mesh.rank * n:(mesh.rank + 1) * n] for k, v in batch.items()}
    out = {}
    for dtype in dtypes:
        cfg = dataclasses.replace(_dp_config(cfg0), compute_dtype=dtype,
                                  mesh=C.MeshConfig(data=data, model=model))
        step = _new_step(torch, dev, cfg, mesh, shard=True)
        m = step.state.model
        plan = m.tp_plan
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        loss = step(local, torch.Generator().manual_seed(5),
                    use_gold=DP_USE_GOLD)["loss"].item()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        grads = {n: gather_from_model(p.grad, mesh, plan[n][0]) if n in plan
                 else p.grad.detach().clone() for n, p in m.named_parameters()}
        after = gather_state_dict(m.state_dict(), m)    # every process gathers
        res = dict(loss=loss, launches=launches, sharded=len(plan),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   grad_norms={k: v.float().norm().item() for k, v in grads.items()})
        if rank == 0:
            res.update(grads={k: v.cpu() for k, v in grads.items()},
                       after={k: v.cpu() for k, v in after.items()})
        out[dtype] = res
        del step, m, grads, after
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    shutdown()
    return 0


def _run_workers(torch, phase: str, world: int, tmp: str):
    """Start ``world`` processes of ``phase`` on the card, writing into
    ``tmp``, and return what each saved."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-worker", phase,
         str(r), str(port), tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        # four processes share the card's memory: less fragmentation
        env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"process {r}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    check(not failed, f"{phase} failed: " + "\n".join(failed))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def phase_tp(torch, np, dev):
    """E7: the tensor-parallel step at the full width (``sbl``, B=240
    global, remat on, PALLAS_INGEST=1 PALLAS_BN=1, dropout on with its
    masks drawn, gold fed at every decode step) on gloo grids on the one
    card -- model = 2 in f32 and bf16, data 2 x model 2 in f32 -- against
    the one-process step on the whole batch: loss, the gathered gradients
    (E4's comparison), the gathered parameters after the update and the BN
    running statistics.  Peak memory a process is printed."""
    import tempfile
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import noam_lr

    def on_host(step, rec):
        sd = step.state.model.state_dict()
        return (rec[0], {k: v.cpu() for k, v in rec[1].items()},
                {k: v.cpu() for k, v in rec[2].items()},
                {k: v.cpu() for k, v in sd.items()})
    refs = {}
    cfg0, batch = _path_e_setup(torch, np, dev, TRAIN_BATCH)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(_dp_config(cfg0), compute_dtype=dtype)
        if dtype == "float32":
            # the one-process step's own rounding floor (plain BatchNorm)
            _set_switches(False)
            step = _new_step(torch, dev, cfg)
            refs["alt"] = on_host(step, _step_record(torch, step, batch,
                                                     use_gold=DP_USE_GOLD))
            del step
        _set_switches(True)
        step = _new_step(torch, dev, cfg)
        refs[dtype] = on_host(step, _step_record(torch, step, batch,
                                                 use_gold=DP_USE_GOLD))
        del step
        torch.cuda.empty_cache()
    lr = noam_lr(0, cfg0.optim.k, cfg0.optim.warmup_steps, cfg0.optim.lr_base_dim)
    del batch
    torch.cuda.empty_cache()
    out, launches, turns = {}, None, []
    for i, (grid, data, model, dtypes) in enumerate(TP_GRIDS):
        with tempfile.TemporaryDirectory() as tmp:
            ranks = _run_workers(torch, f"E7-{i}", data * model, tmp)
        turns += [(f"{grid} {dtype}", model, dtype, [r[dtype] for r in ranks])
                  for dtype in dtypes]
    for name, model, dtype, ranks in turns:
        r0 = ranks[0]
        want = refs[dtype]
        got = (r0["loss"], r0["grads"], {k: v for k, v in r0["after"].items()
                                          if "running" in k})
        if dtype == "float32":
            res = _compare_dp_step(got, want[:3], refs["alt"][:3], f"E7 {name}")
        else:
            errs = _grad_errors(got[1], want[1])
            worst = max(errs, key=errs.get)
            bn_err = max((got[2][n] - b).abs().max().item()
                         for n, b in want[2].items())
            print(f"phase E7 {name} vs one process: loss {got[0]:.6f} vs "
                  f"{want[0]:.6f} (tol {TP_BF16_TOL['loss']}); gradient rel err "
                  f"max {errs[worst]:.3g} at {worst}, median "
                  f"{statistics.median(errs.values()):.3g} (tol "
                  f"{TP_BF16_TOL['grad']}); BN running stats max abs diff "
                  f"{bn_err:.3g} (tol {TP_BF16_TOL['bn']})")
            check(abs(got[0] - want[0]) <= TP_BF16_TOL["loss"], f"E7 {name}: loss")
            check(errs[worst] <= TP_BF16_TOL["grad"], f"E7 {name}: gradients")
            check(bn_err <= TP_BF16_TOL["bn"], f"E7 {name}: BN stats")
            res = dict(loss_err=abs(got[0] - want[0]), grad_err_max=errs[worst],
                       grad_err_median=statistics.median(errs.values()),
                       bn_err=bn_err)
        param_err = max((r0["after"][k] - v).abs().max().item()
                        for k, v in want[3].items() if "running" not in k)
        check(param_err <= 2 * lr + 1e-6,
              f"E7 {name}: parameters after the update differ by {param_err}")
        for r in ranks[1:]:
            check(r["loss"] == r0["loss"], f"E7 {name}: the processes' losses differ")
        # the model processes of a data index hold the same gathered gradients
        for a in range(0, len(ranks), model):
            for b in range(a + 1, a + model):
                check(ranks[b]["grad_norms"] == ranks[a]["grad_norms"],
                      f"E7 {name}: processes {a} and {b} gather other gradients")
        for r in ranks:
            check(r["launches"]["small_mha_dropout_fwd_flat"] > 0
                  and r["launches"]["small_mha_dropout_bwd_flat"] > 0,
                  f"E7 {name}: K3/K4 not launched")
        print(f"phase E7 {name}: {r0['sharded']} tensors sharded a process; "
              f"parameters after the update within {param_err:.3g} (2 lr = "
              f"{2 * lr:.3g}); launches a process {r0['launches']}; peak GB a "
              f"process {[round(r['peak_gb'], 2) for r in ranks]}")
        res.update(param_err=param_err, peak_gb=[r["peak_gb"] for r in ranks])
        out[name] = res
        if launches is None:
            launches = r0["launches"]
    _set_switches(False)
    return launches, out


def _e8_config():
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    return dataclasses.replace(C.sbl(), batch_size=E8_BATCH, compute_dtype="float32",
                               use_fused_decoder_layer=True)


def _e8_data(cfg):
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    return SyntheticLipDataset(size=2 * E8_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=4)


def _e8_decode(torch, np, dev, model, cfg, data):
    """Greedy tokens and logits of the first E8_BATCH clips (K11 on)."""
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
    clips = torch.as_tensor(np.stack([data[i]["clip_u8"] for i in range(E8_BATCH)]),
                            device=dev)
    rec = recognize_batch(model, clips, cfg.data.crop_size)
    return {k: t.cpu() for k, t in zip(("ys_l2r", "ys_r2l", "logits_l2r",
                                        "logits_r2l"), rec)}


def _e8_worker(torch, np, dev, rank, port, outdir):
    """E8: a Trainer on a (1, 2) gloo grid: two steps and a validation
    batch of ``sbl`` (f32, K11 on), its checkpoint, and the greedy decode
    of the eval clips with K11's launches counted."""
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import make_mesh, shutdown
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    mesh = make_mesh(1, 2, device=dev, rank=rank, backend="gloo",
                     init_method=f"tcp://localhost:{port}")
    cfg = _e8_config()
    data = _e8_data(cfg)
    tr = Trainer(cfg, data, {"synthetic": data}, checkpoint_dir=os.path.join(
        outdir, "ckpt"), device=dev, mesh=mesh)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = tr.fit(1, max_steps_per_epoch=2, max_eval_batches=1)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    ops.reset_launch_counts()
    tokens = _e8_decode(torch, np, dev, tr.model, cfg, data)
    torch.cuda.synchronize()
    decode_launches = ops.launch_counts()
    torch.save(dict(step=tr.state.step, result=res, launches=launches,
                    decode_launches=decode_launches, tokens=tokens,
                    whole_in_eval=sum(getattr(m, "whole_in_eval", False)
                                      for m in tr.model.modules())),
               os.path.join(outdir, f"rank{rank}.pt"))
    shutdown()
    return 0


def phase_tp_trainer(torch, np, dev):
    """E8: a Trainer on a (1, 2) gloo grid on the card (``sbl`` at the full
    width, f32, K11 on): two steps, one validation batch, a checkpoint.  The
    checkpoint loads at model = 1, whose greedy tokens equal the
    tensor-parallel decode's (ties within TIE_TOL aside), and K11 was
    launched in the grid's validation and decode."""
    import tempfile
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    cfg = _e8_config()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _run_workers(torch, "E8", 2, tmp)
        tr = Trainer(cfg, [], device=dev)
        epoch = tr.restore(os.path.join(tmp, "ckpt"))
    check(tr.state.step == 2 and epoch == 0,
          f"E8: the checkpoint holds step {tr.state.step}, epoch {epoch}")
    data = _e8_data(cfg)
    want = _e8_decode(torch, np, dev, tr.model, cfg, data)
    ties, per_decode = 0, cfg.dims.n_dec_layers * cfg.decoder.maxlen
    for r in ranks:
        check(r["step"] == 2, "E8: the grid took other than two steps")
        check(r["decode_launches"]["fused_decoder_layer"] == per_decode,
              f"E8: K11 launched {r['decode_launches']['fused_decoder_layer']} "
              f"times in a decode, not {per_decode}")
        check(r["launches"]["fused_decoder_layer"] >= per_decode,
              "E8: K11 not launched in the validation")
        for d in ("l2r", "r2l"):
            got, ref = r["tokens"][f"ys_{d}"], want[f"ys_{d}"]
            for b in range(got.shape[0]):
                diff = (got[b] != ref[b]).nonzero()
                if len(diff) == 0:
                    continue
                t = int(diff[0]) - 1        # the step whose argmax differs
                lg = want[f"logits_{d}"][b, t]
                gap = abs(lg[got[b, t + 1]] - lg[ref[b, t + 1]]).item()
                check(gap <= TIE_TOL, f"E8 {d} sample {b}: tokens differ at step "
                      f"{t} with a logit gap {gap}")
                ties += 1
    check(ranks[0]["whole_in_eval"] > 0, "E8: no module runs whole in eval")
    print(f"phase E8 Trainer on a (1, 2) gloo grid, sbl f32 with K11: 2 steps, "
          f"validation {ranks[0]['result']}, checkpoint loaded at model = 1 (step "
          f"{tr.state.step}); greedy tokens at model = 1 equal the grid's "
          f"({ties} sequences differ at a tie within {TIE_TOL}); K11 launched "
          f"{ranks[0]['decode_launches']['fused_decoder_layer']} times a decode a "
          f"process, fit's launches {ranks[0]['launches']}")
    del tr
    torch.cuda.empty_cache()
    return ranks[0]["launches"], dict(ties=ties, result=ranks[0]["result"])


def _scalar_steps(log_dir: str, tag: str):
    """The steps at which ``tag`` was logged: from metrics.jsonl, or from
    the TensorBoard event file where the tensorboard package wrote one."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            return [r["step"] for r in map(json.loads, f) if r["tag"] == tag]
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return [e.step for e in acc.Scalars(tag)]


def _compare_dp_step(got, want, alt, label="E4 W=2 (gloo, one card)"):
    """Phase E4's comparison, f32.  Loss and running statistics within phase
    5's tolerances; the gradient as a whole (||got - want|| / ||want|| over
    every parameter) within TRAIN_GRAD_TOL, and each parameter's within
    TRAIN_GRAD_TOL or, where the one-process step itself moves by more
    between two roundings of its BatchNorm statistics (``alt``: the plain
    BatchNorm's), within twice that movement.  The processes' forwards
    differ from the one process's in the last bits (their BatchNorm sums are
    added in another order, cuDNN picks its algorithms by batch size), and
    at B=240 some of the ~1e9 ReLU inputs of the frontend lie within that
    of 0 and take the kink's other side: the scale and bias gradients of a
    BatchNorm, sums that cancel, move by up to a few 1e-3 of their norm."""
    (lg, gg, sg), (lw, gw, sw), (_, ga, _) = got, want, alt
    errs, floor = _grad_errors(gg, gw), _grad_errors(ga, gw)
    whole = (_norm_sq(gg, gw) / _norm_sq(gw)) ** 0.5
    worst = max(errs, key=errs.get)
    over = {n: (e, floor[n]) for n, e in errs.items() if e > TRAIN_GRAD_TOL["float32"]}
    bn_err = max((sg[n] - b).abs().max().item() for n, b in sw.items())
    print(f"phase {label} vs one process on the whole batch "
          f"float32: loss {lg:.6f} vs {lw:.6f} (tol {TRAIN_LOSS_TOL['float32']}); "
          f"gradient rel err {whole:.3g} as a whole (tol "
          f"{TRAIN_GRAD_TOL['float32']}), per parameter max {errs[worst]:.3g} at "
          f"{worst}, median {statistics.median(errs.values()):.3g}; above the "
          f"tolerance {len(over)} of {len(errs)}, each against the one-process "
          f"step's own movement (plain vs kernel BatchNorm, max "
          f"{max(floor.values()):.3g}): "
          + ", ".join(f"{n} {e:.3g} / {f:.3g}" for n, (e, f) in sorted(over.items()))
          + f"; BN running stats max abs diff {bn_err:.3g} (tol "
          f"{TRAIN_BN_TOL['float32']})")
    check(abs(lg - lw) <= TRAIN_LOSS_TOL["float32"], f"{label}: losses differ")
    check(whole <= TRAIN_GRAD_TOL["float32"], f"{label}: gradients differ by {whole}")
    for n, (e, f) in over.items():
        check(e <= 2 * f, f"{label}: gradient of {n} differs by {e}, the "
              f"one-process step's own rounding moves it by {f}")
    check(bn_err <= TRAIN_BN_TOL["float32"], f"{label}: BN stats differ")
    return dict(loss_err=abs(lg - lw), grad_err=whole, grad_err_max=errs[worst],
                over=over, bn_err=bn_err)


def _norm_sq(a, b=None):
    """The squared norm of every tensor of ``a`` (less ``b``) together."""
    return sum(float(((t - b[n]) if b is not None else t).double().pow(2).sum())
               for n, t in a.items())


def _kernel_names(trace_path: str):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def phase_path_e_cli(torch, np, dev):
    """E5: `cli train --mesh-data 1 --remat-frontend --profile-dir D
    --tensorboard-dir T`, two steps, PALLAS_INGEST=1 PALLAS_BN=1: launches
    as counted, the trace names K3's, K4's, K7's and K8's kernels, and the
    scalar log has train/loss at each step."""
    import re
    import tempfile
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches as recognize_launches)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches)
    _set_switches(True)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir, log_dir = os.path.join(tmp, "trace"), os.path.join(tmp, "tb")
        tr, out, launches = _cli_train(torch, cli, ops, [
            "--workload", "sbl", "--synthetic", "--synthetic-size",
            str(ENTRY_STEPS * TRACE_BATCH), "--batch-size", str(TRACE_BATCH),
            "--epochs", "1", "--max-steps-per-epoch", str(ENTRY_STEPS),
            "--max-eval-batches", "1", "--mesh-data", "1", "--remat-frontend",
            "--profile-dir", trace_dir, "--tensorboard-dir", log_dir,
            "--save-dir", os.path.join(tmp, "ckpt")])
        cfg = dataclasses.replace(C.sbl(), remat_frontend=True)
        per_step = expected_launches(cfg)
        expected = {k: ENTRY_STEPS * per_step[k] + len(tr.valid_datasets) * v
                    for k, v in recognize_launches(cfg).items()}
        check(launches == expected, f"E5 launches {launches} != {expected}")
        names = _kernel_names(os.path.join(trace_dir, "trace.json"))
        found = {
            "K3": any("dropout_attention_fwd" in n for n in names),
            "K4": any("dropout_attention_bwd" in n for n in names),
            "K7": any("channel_sums_kernel" in n and re.search(r"(false|Lb0E)", n)
                      for n in names),
            "K8": any("channel_sums_kernel" in n and re.search(r"(true|Lb1E)", n)
                      for n in names)}
        check(all(found.values()), f"E5 trace lacks kernels: {found}; "
              f"{sorted(n for n in names if 'kernel' in n)[:20]}")
        loss_steps = _scalar_steps(log_dir, "train/loss")
        check(loss_steps == list(range(1, ENTRY_STEPS + 1)),
              f"E5 train/loss at steps {loss_steps}")
        size = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    print(f"phase E5 cli train --mesh-data 1 --remat-frontend --profile-dir: "
          f"{ENTRY_STEPS} steps of B={TRACE_BATCH}, launches "
          f"{launches} (expected {expected}); trace of {size / 1e6:.1f} MB with "
          f"{len(names)} kernel names, K3/K4/K7/K8 among them; train/loss at "
          f"steps {loss_steps}; loss {out['train_loss']:.4f}")
    _set_switches(False)
    del tr
    torch.cuda.empty_cache()
    return launches, dict(loss=out["train_loss"])


def phase_memorize(torch, np, dev):
    """E6: convergence_check's default mode on the card, within its budget."""
    from sbl_for_multilingual_lip_reading_tpu_torch import convergence_check
    out = convergence_check.memorize(MEMORIZE_STEPS, dev,
                                     log=lambda s: print(f"phase E6 {s}"))
    print(f"phase E6 convergence_check default mode: "
          f"{'MEMORIZED' if out['memorized'] else 'NOT memorized'} at step "
          f"{out['step']} of {MEMORIZE_STEPS}")
    check(out["memorized"], "E6: the default mode did not memorize")
    return dict(step=out["step"])


def _release(torch):
    """Free the card's memory of the Trainers dropped: a Trainer sits in
    reference cycles (its steps' closures), and its CUDA graph's private
    pool goes only with it."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _route(fused: bool):
    """The environment that selects a cached Trainer's route: the
    epoch-fused one (the whole step one CUDA graph, replayed once a step),
    or with SBL_NO_EPOCH_FUSED=1 the per-step one (JAX's switch)."""
    old = os.environ.pop("SBL_NO_EPOCH_FUSED", None)
    if not fused:
        os.environ["SBL_NO_EPOCH_FUSED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SBL_NO_EPOCH_FUSED", None)
        if old is not None:
            os.environ["SBL_NO_EPOCH_FUSED"] = old


def _e9_dataset(cfg):
    """E9_CLIPS SyntheticPatternDataset clips (24 a word), built once."""
    from sbl_for_multilingual_lip_reading_tpu_torch.data import (
        SyntheticPatternDataset)
    spw = 24
    ds = SyntheticPatternDataset(n_words=E9_CLIPS // spw, samples_per_word=spw,
                                 frames=cfg.data.frames,
                                 raw_size=cfg.data.raw_size)
    for i in range(len(ds)):
        ds[i]
    return ds


def _fused_run(torch, ops, tr, fused, steps, epoch=0):
    """``steps`` steps of a cached Trainer on a route, the launch counts set
    to 0 just before and read just after: a dict of the losses, each
    parameter's update (after minus before: exact in f32, the two within a
    factor 2), Adam's first moments, the set of Adam's step counts, and the
    counts."""
    params = dict(tr.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    history = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with _route(fused):
        tr.train_epoch(epoch, max_steps=steps, history=history)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    state = tr.state.optimizer.state
    return dict(losses=[h["loss"] for h in history],
                updates={n: p.detach() - before[n] for n, p in params.items()},
                moments={n: state[p]["exp_avg"].clone()
                         for n, p in params.items()},
                adam_steps={float(state[p]["step"]) for p in params.values()},
                counts=counts)


@contextlib.contextmanager
def _deterministic(torch):
    """cuDNN's deterministic algorithms and torch's deterministic
    implementations while the block runs, then the settings as they were;
    yields the set of warnings of ops that have none (cuBLAS's workspace
    setting among them: its GEMMs on one stream repeat their sums)."""
    import warnings
    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    seen = set()
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
            seen.update(str(w.message).split(".")[0][:100] for w in caught)
    finally:
        cudnn.deterministic, cudnn.benchmark = old[:2]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])


def _update_errors(kern, plain, moments):
    """Per parameter ||kernel update - plain update|| / ||plain update||,
    leaving out the parameters whose gradient is rounding noise: Adam's
    first moment on the plain route under 1e-3 of the largest, as
    ``_grad_errors`` floors gradients.  Adam moves every element by about
    the lr whatever its gradient's size, so the update of a gradient that
    is zero in exact arithmetic (the key projections' biases: a softmax does
    not see a shift of all its scores) takes rounding noise's sign.
    Returns (errors, the names left out)."""
    norms = {n: m.norm().item() for n, m in moments.items()}
    floor = 1e-3 * max(norms.values())
    errs = {n: (kern[n] - u).norm().item() / u.norm().item()
            for n, u in plain.items() if norms[n] >= floor}
    return errs, sorted(set(plain) - set(errs))


def _check_graphed(tr, cfg, label, replays):
    """The Trainer's fused step was captured as a CUDA graph, replayed
    ``replays`` times, with the kernels' captured counts as counted."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        GraphedStep, expected_launches)
    fs = tr.fused_step
    check(isinstance(fs, GraphedStep) and fs.graph is not None,
          f"{label}: the fused step was not captured as a CUDA graph")
    check(fs.replays == replays, f"{label}: {fs.replays} replays, not {replays}")
    want = expected_launches(cfg)
    check(fs.captured_launches == want, f"{label}: captured launches "
          f"{fs.captured_launches} != {want}")
    return fs


def _fused_resume(torch, np, dev):
    """A checkpoint written on the CPU (Adam not ``capturable``: its step
    counts load onto the host) resumed by a cached Trainer on the card for
    two steps of the graphed route, against the CPU Trainer's own next two
    steps: the tiny ``sbl`` preset, f32, every dropout rate 0 (the CPU's and
    the card's mask generators draw differently)."""
    import tempfile
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    tiny = C.tiny_test("sbl")
    cfg = dataclasses.replace(
        tiny, batch_size=E9_RESUME_BATCH,
        dims=dataclasses.replace(tiny.dims, dropout=0.0),
        frontend=dataclasses.replace(tiny.frontend, dropout=0.0))
    data = SyntheticLipDataset(size=3 * E9_RESUME_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0)
    cpu = Trainer(cfg, data, device="cpu", cache_on_device=True)
    cpu.train_epoch(0, max_steps=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ckpt")
        cpu.save(path, epoch=0)
        card = Trainer(cfg, data, device=dev, cache_on_device=True)
        card.restore(path)
    history = []
    cpu.train_epoch(1, max_steps=2, history=history)
    want = [h["loss"] for h in history]
    got = _fused_run(torch, ops, card, True, 2, epoch=1)
    _check_graphed(card, cfg, "E9 resume", 1)
    on_card = {s["step"].device.type for s in card.state.optimizer.state.values()}
    err = max(abs(a - b) for a, b in zip(got["losses"], want))
    print(f"phase E9 resumed on the card from a CPU checkpoint (tiny sbl f32, "
          f"B={E9_RESUME_BATCH}): 2 graphed steps, losses {got['losses']} vs "
          f"the CPU's {want} (max abs diff {err:.3g}, tol "
          f"{TRAIN_LOSS_TOL['float32']}); Adam's step counts "
          f"{sorted(got['adam_steps'])} on {sorted(on_card)}")
    check(on_card == {"cuda"} and got["adam_steps"] == {3.0},
          "E9 resume: Adam's step counts are not on the card at 3")
    check(err <= TRAIN_LOSS_TOL["float32"], "E9 resume: the losses differ")
    del card, cpu
    _release(torch)
    return dict(loss_err=err)


def phase_fused(torch, np, dev):
    """E9: the epoch-fused cached route (``cache_on_device``, the Trainer's
    default for a cached dataset) at the full ``sbl`` width, B=240,
    PALLAS_INGEST=1 PALLAS_BN=1, remat on, on E9_CLIPS clips resident on
    the card (6 steps an epoch): f32 (TF32 off, deterministic algorithms)
    E9_CHECK_STEPS steps of the graphed route against the per-step route (SBL_NO_EPOCH_FUSED=1; losses
    within E9_LOSS_RTOL, each parameter's update within E9_UPDATE_TOL,
    Adam's step counts equal to the steps) and the per-step route's first
    step against the host batch route's; the graph captured once, replayed
    once a step, its captured launches as counted; then bf16, each route in
    a fresh Trainer for two epochs (the fused route's captured launches as
    counted, the routes' losses bit for bit), one NCCL W = 1 fused
    run against the one without a mesh (E3's tolerance), and a CPU
    checkpoint resumed on the card (``_fused_resume``)."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import (
        SyntheticPatternDataset)
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    _set_switches(True)
    base = dataclasses.replace(C.sbl(), batch_size=TRAIN_BATCH,
                               remat_frontend=True)
    ds = _e9_dataset(base)
    out = {}
    cfg = dataclasses.replace(base, compute_dtype="float32")
    runs, undetermined = {}, set()
    for name, fused, cache, steps in (("fused", True, True, E9_CHECK_STEPS),
                                      ("per_step", False, True, E9_CHECK_STEPS),
                                      ("host", False, False, 1)):
        tr = Trainer(cfg, ds, device=dev, cache_on_device=cache)
        with _deterministic(torch) as seen:
            runs[name] = _fused_run(torch, ops, tr, fused, steps)
        undetermined |= seen
        want = expected_launches(cfg)
        if name == "fused":
            _check_graphed(tr, cfg, "E9 f32", E9_CHECK_STEPS - 1)
            # the eager warm-up step and the capture ran the wrappers
            check(runs[name]["counts"] == {k: 2 * v for k, v in want.items()},
                  f"E9 f32 fused: launches {runs[name]['counts']}")
        else:
            check(runs[name]["counts"] == {k: steps * v for k, v in want.items()},
                  f"E9 f32 {name}: launches {runs[name]['counts']}")
        del tr
        _release(torch)
    rf, rp = runs["fused"], runs["per_step"]
    counts = rf["counts"]
    lf, lp, lh = rf["losses"], rp["losses"], runs["host"]["losses"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lf, lp))
    errs, left_out = _update_errors(rf["updates"], rp["updates"], rp["moments"])
    top = sorted(errs, key=errs.get, reverse=True)[:3]
    bit_equal = sum(torch.equal(rf["updates"][n], rp["updates"][n]) for n in errs)
    host_err = abs(lp[0] - lh[0]) / abs(lh[0])
    print(f"phase E9 f32 graphed fused vs per-step route, {E9_CHECK_STEPS} "
          f"steps: losses {[round(x, 6) for x in lf]} vs "
          f"{[round(x, 6) for x in lp]} (rel err max {loss_err:.3g}, tol "
          f"{E9_LOSS_RTOL}); updates rel err over {len(errs)} parameters "
          f"({bit_equal} bit-equal), largest "
          f"{', '.join(f'{n} {errs[n]:.3g}' for n in top)} (tol "
          f"{E9_UPDATE_TOL}); {len(left_out)} left out as rounding noise "
          f"({', '.join(left_out[:4])}{', ...' if len(left_out) > 4 else ''}); "
          f"Adam's step counts {sorted(rf['adam_steps'])} vs "
          f"{sorted(rp['adam_steps'])}; per-step route vs host route step 0 "
          f"loss rel err {host_err:.3g}; ops without a deterministic "
          f"implementation: {sorted(undetermined) or 'none'}")
    check(loss_err <= E9_LOSS_RTOL, "E9 f32: the routes' losses differ")
    check(rf["adam_steps"] == rp["adam_steps"] == {float(E9_CHECK_STEPS)},
          "E9 f32: Adam's step counts differ from the steps taken")
    check(errs[top[0]] <= E9_UPDATE_TOL,
          f"E9 f32: the updates of {top[0]} differ by {errs[top[0]]}")
    check(host_err <= E9_LOSS_RTOL, "E9 f32: the per-step route's step 0 "
          "differs from the host route's")
    out.update(f32_loss_rel_err=loss_err, f32_update_err=errs[top[0]],
               f32_update_left_out=len(left_out), host_rel_err=host_err)
    del runs, rf, rp
    _release(torch)
    bf16 = base
    routes = {}
    for name, fused in (("fused", True), ("per_step", False)):
        # a fresh Trainer for two epochs: the first builds, warms up and
        # captures
        tr = Trainer(bf16, ds, device=dev, cache_on_device=True)
        history = []
        with _route(fused):
            for epoch in range(2):
                tr.train_epoch(epoch, history=history)
        routes[name] = dict(losses=[h["loss"] for h in history])
        if fused:
            routes[name]["captured_launches"] = tr.fused_step.captured_launches
        del tr
        _release(torch)
    lf, lp = routes["fused"]["losses"], routes["per_step"]["losses"]
    check(routes["fused"]["captured_launches"] == expected_launches(bf16),
          "E9 bf16: captured launches differ from expected_launches")
    check(all(np.isfinite(x) for m in routes.values() for x in m["losses"]),
          "E9 bf16: a non-finite loss")
    # the same kernels on the same inputs, in bf16 with no order-dependent
    # sum: every step's loss bit for bit (each run so far)
    print(f"phase E9 bf16 B={bf16.batch_size} {len(lf)} losses graphed vs "
          f"per-step: {'bit-equal' if lf == lp else f'{lf} vs {lp}'}; step 0 "
          f"{lf[0]:.6f}")
    check(len(lf) == len(lp) == 2 * (len(ds) // bf16.batch_size) and lf == lp,
          "E9 bf16: the routes' losses differ")
    out["bf16"] = routes
    del ds
    # one NCCL W = 1 fused run against the run without a mesh, f32
    small = SyntheticPatternDataset(n_words=4, samples_per_word=8,
                                    frames=base.data.frames,
                                    raw_size=base.data.raw_size)
    c16 = dataclasses.replace(cfg, batch_size=TRAIN_CHECK_BATCH)
    want = _fused_run(torch, ops, Trainer(c16, small, device=dev,
                                          cache_on_device=True), True, 2)["losses"]
    _release(torch)
    mesh = make_mesh(1, device=dev, init_method=f"tcp://localhost:{_free_port()}")
    check(mesh.backend == "nccl", f"E9: backend {mesh.backend}")
    try:
        c16m = dataclasses.replace(c16, mesh=C.MeshConfig(data=1))
        tr = Trainer(c16m, small, device=dev, cache_on_device=True, mesh=mesh)
        got = _fused_run(torch, ops, tr, True, 2)["losses"]
        _check_graphed(tr, c16m, "E9 NCCL W=1", 1)
        check(tr._dev_clips.shape[0] == len(small), "E9 NCCL: cache rows")
        del tr
        _release(torch)
    finally:
        shutdown()
    nccl_err = max(abs(a - b) for a, b in zip(got, want))
    print(f"phase E9 NCCL W=1 graphed fused run vs no mesh, 2 steps at "
          f"B={TRAIN_CHECK_BATCH} f32: losses {got} vs {want} (max abs diff "
          f"{nccl_err:.3g}, tol {TRAIN_LOSS_TOL['float32']})")
    check(nccl_err <= TRAIN_LOSS_TOL["float32"], "E9: the NCCL run differs")
    out["nccl_loss_err"] = nccl_err
    out["resume"] = _fused_resume(torch, np, dev)
    _set_switches(False)
    _release(torch)
    return counts, out


def _switch_env(names):
    """Turn on the frontend's BatchNorm switches ``names`` (FUSED_BN_ACT,
    DOT_BN, PALLAS_BN) for the models built until ``_restore_env``, the
    others off; returns the environment's values before."""
    every = ("FUSED_BN_ACT", "DOT_BN", "PALLAS_BN", "NO_FUSED_BN_ACT", "NO_DOT_BN")
    old = {k: os.environ.pop(k, None) for k in every}
    os.environ.update({k: "1" for k in names})
    return old


def _restore_env(old):
    for k, v in old.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def phase_bn_variants(torch, np, dev):
    """F1: ``ops/bn_relu.py::bn_act_train`` (FusedBNAct) and
    ``ops/bn_dot.py::bn_train_dot`` (DotBatchNorm), forward and backward in
    bf16 at the frontend's five BatchNorm shapes of the B=240 step: their
    statistics against float64 sums of the same x (within F1_STAT_TOL of
    the mean of |x| and of x^2: an f32 sum in another order, where a bf16
    or TF32 result would be 2^-9 off), and each module against the port's
    ``BatchNorm`` on the same x, weights and dy: FusedBNAct against
    BatchNorm composed with the residual add and the ReLU as the default
    frontend runs them (the stem without a residual), DotBatchNorm against
    BatchNorm alone (both f32 out), in y, dx, dscale, dbias and dres
    (relative L2 within F1_TOL) and the running statistics (within
    F1_RUNNING_TOL); the device time of each forward + backward."""
    import torch.nn.functional as F
    from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import (
        BatchNorm, DotBatchNorm, FusedBNAct)
    from sbl_for_multilingual_lip_reading_tpu_torch.ops.bn_dot import bn_train_dot
    from sbl_for_multilingual_lip_reading_tpu_torch.ops.bn_relu import bn_act_train
    bf16 = torch.bfloat16
    rows = []
    for name, (C, H, W), _ in BN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(C * H)
        shape = (BN_FRAMES, C, H, W)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.7).to(bf16)
        res = None if name == "stem" else torch.randn(
            shape, generator=g, device=dev).to(bf16)
        dy = torch.randn(shape, generator=g, device=dev).to(bf16)
        scale = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        bias = torch.randn(C, generator=g, device=dev) * 0.1
        x64 = x.double()
        m64, q64 = x64.mean((0, 2, 3)), (x64 * x64).mean((0, 2, 3))
        ax, aq = x64.abs().mean().item(), q64.mean().item()
        del x64
        stat = {}
        with torch.no_grad():
            for op, (_, mean, var) in (
                    ("fused", bn_act_train(x, scale, bias, res, eps=1e-5)),
                    ("dot", bn_train_dot(x, scale, bias, 1e-5))):
                stat[op] = max(
                    (mean.double() - m64).abs().max().item() / ax,
                    (var.double() + mean.double() ** 2 - q64).abs().max().item() / aq)

        def run(kind, act):
            """Forward and backward of a fresh ``kind`` module: with ``act``
            the block's residual add and ReLU after it (FusedBNAct's own)."""
            m = kind(C).to(dev).train()
            with torch.no_grad():
                m.weight.copy_(scale)
                m.bias.copy_(bias)
            xr = x.clone().requires_grad_(True)
            rr = None if res is None or not act else res.clone().requires_grad_(True)

            def fwd_bwd():
                for t in (xr, rr, m.weight, m.bias):
                    if t is not None:
                        t.grad = None
                if kind is FusedBNAct:
                    y = m(xr, rr)
                elif not act:
                    y = m(xr)
                elif rr is None:
                    y = F.relu(m(xr)).to(bf16)
                else:
                    y = F.relu(m(xr).to(bf16) + rr)
                y.backward(dy.to(y.dtype))
                return y
            y = fwd_bwd().detach()
            out = dict(y=y, dx=xr.grad, dscale=m.weight.grad, dbias=m.bias.grad,
                       running=(m.running_mean.clone(), m.running_var.clone()))
            if rr is not None:
                out["dres"] = rr.grad
            out["ms"] = cuda_ms(torch, fwd_bwd)
            return out

        row = dict(case=f"{name} ({BN_FRAMES},{C},{H},{W})", stat_err=stat)
        for op, kind, act in (("fused", FusedBNAct, True), ("dot", DotBatchNorm, False)):
            want, got = run(BatchNorm, act), run(kind, act)
            errs = {k: _rel_l2(got[k], want[k])
                    for k in ("y", "dx", "dscale", "dbias", "dres") if k in want}
            run_err = max((a - b).abs().max().item()
                          for a, b in zip(got["running"], want["running"]))
            row[op] = dict(errs=errs, running_err=run_err, ms=got["ms"],
                           composed_ms=want["ms"])
            check(stat[op] <= F1_STAT_TOL, f"F1 {name} {op}: statistics off by "
                  f"{stat[op]:.3g} of their scale")
            check(max(errs.values()) <= F1_TOL, f"F1 {name} {op}: {errs}")
            check(run_err <= F1_RUNNING_TOL, f"F1 {name} {op}: running statistics "
                  f"off by {run_err:.3g}")
            del want, got
        print(f"phase F1 bf16 {row['case']}: statistics vs float64 fused "
              f"{stat['fused']:.3g}, dot {stat['dot']:.3g} (tol {F1_STAT_TOL}); "
              + "; ".join(f"{op} vs BatchNorm " + ", ".join(
                  f"{k} {v:.3g}" for k, v in row[op]["errs"].items())
                  + f", running {row[op]['running_err']:.3g}"
                  for op in ("fused", "dot"))
              + f" (tol {F1_TOL}, {F1_RUNNING_TOL}); fwd+bwd ms: FusedBNAct "
              f"{row['fused']['ms']:.3f} vs BatchNorm+add+ReLU "
              f"{row['fused']['composed_ms']:.3f}, DotBatchNorm "
              f"{row['dot']['ms']:.3f} vs BatchNorm {row['dot']['composed_ms']:.3f}")
        rows.append(row)
        del x, res, dy
        torch.cuda.empty_cache()
    return rows


def _switch_step(torch, np, dev, cfg, batch, switches, coins):
    """F2's one variant: the model built under ``switches``, one step under
    deterministic algorithms (loss, gradients, launch counts), a warm-up
    step, then one more step (peak GB allocated and reserved over it)."""
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        make_sbl_train_step)
    _release(torch)
    old = _switch_env(switches)
    try:
        model = build_model(cfg, dev, seed=0)
    finally:
        _restore_env(old)
    step = make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    gen = torch.Generator().manual_seed(5)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with _deterministic(torch):
        loss = step(batch, gen, use_gold=coins)["loss"].item()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    step(batch, gen, use_gold=coins)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(batch, gen, use_gold=coins)
    torch.cuda.synchronize()
    kinds = sorted({type(m).__name__ for m in model.frontend.modules()
                    if hasattr(m, "running_mean")})
    out = dict(loss=loss, grads=grads, counts=counts, kinds=kinds,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    del model, step
    _release(torch)
    return out


def phase_switch_steps(torch, np, dev):
    """F2: one full-width ``sbl`` step (``config.sbl()``, bf16, B=240,
    remat_frontend off, every dropout rate 0, the coins injected, the same
    weights and batch each time) five ways: the switches off, PALLAS_BN=1
    (the noise floor below), FUSED_BN_ACT=1, DOT_BN=1 and
    ``grad_accum_bf16``; against the off step the loss (F2_LOSS_TOL;
    grad_accum_bf16, whose forward is the default's at init, bit for bit)
    and every parameter's gradient by relative L2: grad_accum_bf16 within
    JAX's bound of 0.05; FUSED_BN_ACT and DOT_BN at most F2_FLOOR_FACTOR
    times as far as the PALLAS_BN step (K7/K8's statistics, exact sums) is
    from the off step, or F2_GRAD_TOL, with the median within
    F2_MEDIAN_TOL; each step's K2/K3/K4 launches, and peak memory allocated
    and reserved over a step after a warm-up.
    Then the graphed epoch-fused route at the tiny preset with the
    switches on (``_switched_fused``)."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    base = C.sbl()
    cfg = dataclasses.replace(
        base, batch_size=TRAIN_BATCH, remat_frontend=False,
        dims=dataclasses.replace(base.dims, dropout=0.0),
        frontend=dataclasses.replace(base.frontend, dropout=0.0))
    accum = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, grad_accum_bf16=True))
    data = SyntheticLipDataset(size=TRAIN_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0)
    batch = train_batch(torch, np, dev, cfg, data, TRAIN_BATCH, 1)
    coins = [i % 3 != 2 for i in range(cfg.decoder.maxlen)]
    _set_switches(False)
    runs = {}
    for name, c, switches in (("off", cfg, ()), ("PALLAS_BN", cfg, ("PALLAS_BN",)),
                              ("FUSED_BN_ACT", cfg, ("FUSED_BN_ACT",)),
                              ("DOT_BN", cfg, ("DOT_BN",)),
                              ("grad_accum_bf16", accum, ())):
        runs[name] = _switch_step(torch, np, dev, c, batch, switches, coins)
    off = runs["off"]
    floor = max(_grad_errors(runs["PALLAS_BN"]["grads"], off["grads"]).values())
    out, launches = {"floor": floor}, {}
    for name, r in runs.items():
        for k in ("stack_frames", "small_mha_dropout_fwd_flat",
                  "small_mha_dropout_bwd_flat"):
            check(r["counts"][k] > 0, f"F2 {name}: {k} never launched")
        launches[name] = r["counts"]
        errs = _grad_errors(r["grads"], off["grads"]) if name != "off" else {}
        worst = max(errs, key=errs.get) if errs else None
        rec = {k: r[k] for k in ("loss", "peak_gb", "peak_reserved_gb", "kinds")}
        rec.update(grad_err=errs[worst] if worst else 0.0, grad_err_at=worst)
        out[name] = rec
        tol = (0.05 if name == "grad_accum_bf16" else
               max(F2_GRAD_TOL, F2_FLOOR_FACTOR * floor))
        print(f"phase F2 sbl bf16 B={TRAIN_BATCH} {name} (frontend "
              f"{'/'.join(r['kinds'])}): loss {r['loss']:.6f} vs off "
              f"{off['loss']:.6f}; gradient rel err max "
              + (f"{errs[worst]:.3g} at {worst}, median "
                 f"{statistics.median(errs.values()):.3g} (tol {tol})"
                 if worst else "-")
              + f"; peak {r['peak_gb']:.2f} GB allocated, "
              f"{r['peak_reserved_gb']:.2f} GB "
              f"reserved; K2 {r['counts']['stack_frames']}, K3 "
              f"{r['counts']['small_mha_dropout_fwd_flat']}, K4 "
              f"{r['counts']['small_mha_dropout_bwd_flat']}")
        if name == "grad_accum_bf16":
            check(r["loss"] == off["loss"], "F2 grad_accum_bf16: the forward at "
                  "init differs from the default's")
        elif name != "off":
            check(abs(r["loss"] - off["loss"]) <= F2_LOSS_TOL,
                  f"F2 {name}: loss {r['loss']} vs {off['loss']}")
            check(statistics.median(errs.values()) <= F2_MEDIAN_TOL,
                  f"F2 {name}: median gradient error "
                  f"{statistics.median(errs.values())}")
        if worst and name != "PALLAS_BN":
            check(errs[worst] <= tol, f"F2 {name}: gradient of {worst} differs "
                  f"by {errs[worst]}")
    check(runs["FUSED_BN_ACT"]["kinds"] == ["FusedBNAct"]
          and runs["DOT_BN"]["kinds"] == ["DotBatchNorm"]
          and runs["PALLAS_BN"]["kinds"] == ["FastBatchNorm"],
          "F2: the switches did not build their BatchNorms")
    del runs
    _release(torch)
    out["graphed"] = _switched_fused(torch, np, dev)
    return launches, out


def _switched_fused(torch, np, dev):
    """The epoch-fused cached route at the tiny ``sbl`` preset (f32, every
    dropout rate 0, deterministic algorithms), graphed against the per-step
    route over F2_FUSED_STEPS steps, with grad_accum_bf16 and FUSED_BN_ACT,
    then with all three switches (DOT_BN=1, which takes precedence over
    FUSED_BN_ACT): the same losses within E9_LOSS_RTOL, the graph captured
    once and replayed once a step, as E9 checks."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    tiny = C.tiny_test("sbl")
    cfg = dataclasses.replace(
        tiny, batch_size=TINY_BATCH, compute_dtype="float32",
        dims=dataclasses.replace(tiny.dims, dropout=0.0),
        frontend=dataclasses.replace(tiny.frontend, dropout=0.0),
        decoder=dataclasses.replace(tiny.decoder, grad_accum_bf16=True))
    data = SyntheticLipDataset(size=F2_FUSED_STEPS * TINY_BATCH,
                               frames=cfg.data.frames, raw_size=cfg.data.raw_size,
                               seed=0)
    out = {}
    for label, switches, kind in (
            ("FUSED_BN_ACT + grad_accum_bf16", ("FUSED_BN_ACT",), "FusedBNAct"),
            ("all three", ("FUSED_BN_ACT", "DOT_BN"), "DotBatchNorm")):
        old = _switch_env(switches)
        try:
            losses = {}
            for route in (True, False):
                tr = Trainer(cfg, data, device=dev, cache_on_device=True)
                kinds = {type(m).__name__ for m in tr.model.frontend.modules()
                         if hasattr(m, "running_mean")}
                check(kinds == {kind} and tr.model.decoder.grad_accum_bf16,
                      f"F2 graphed {label}: built {kinds}")
                with _deterministic(torch):
                    losses[route] = _fused_run(torch, ops, tr, route,
                                               F2_FUSED_STEPS)["losses"]
                if route:
                    _check_graphed(tr, cfg, f"F2 graphed {label}", F2_FUSED_STEPS - 1)
                del tr
                _release(torch)
        finally:
            _restore_env(old)
        err = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
        print(f"phase F2 graphed epoch-fused route, tiny sbl f32 B={TINY_BATCH}, "
              f"{label}: losses {losses[True]} vs per-step route "
              f"{losses[False]} (rel err max {err:.3g}, tol {E9_LOSS_RTOL})")
        check(len(losses[True]) == F2_FUSED_STEPS and err <= E9_LOSS_RTOL,
              f"F2 graphed {label}: the routes' losses differ")
        out[label] = dict(losses=losses[True], per_step=losses[False], rel_err=err)
    return out


def phase_native(torch, np, dev):
    """F3: the native host runtime built with g++ from csrc/sbl_native.cc
    (a build that fails fails the phase): ``levenshtein_native`` against
    the Python ``levenshtein`` on F3_PAIRS seeded random pairs (empty ones
    among them), and ``load_clip_batch`` on F3_CLIPS temporary .npy clips of
    the LRW shape (29, 96, 96) uint8 into (30, 96, 96) against ``np.load``,
    with its clips/s at 4 threads (median of 5 loads; the files are in the
    page cache: a warm read).  The machine has no OpenCV, so the jpg-based
    ``Lrw1000Dataset`` and its audio stream are checked on the CPU tests
    only."""
    import tempfile
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import metrics, native
    t0 = time.perf_counter()
    check(native.build(verbose=True), "F3: the native runtime did not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    pairs = [([], []), ([], [1, 2]), ([3], [])] + [
        (rng.integers(0, 58, rng.integers(0, 20)).tolist(),
         rng.integers(0, 58, rng.integers(0, 20)).tolist())
        for _ in range(F3_PAIRS - 3)]
    bad = [(a, b) for a, b in pairs
           if native.levenshtein_native(a, b) != metrics.levenshtein(a, b)]
    check(not bad, f"F3: levenshtein_native differs on {bad[:3]}")
    with tempfile.TemporaryDirectory() as tmp:
        clips, paths = [], []
        for i in range(F3_CLIPS):
            clip = rng.integers(0, 256, (29, 96, 96), dtype=np.uint8)
            paths.append(str(Path(tmp) / f"clip{i}.npy"))
            np.save(paths[-1], clip)
            clips.append(clip)
        out = native.load_clip_batch(paths, 30, 96, 96, nthreads=4)
        want = np.zeros_like(out)
        for i, p in enumerate(paths):
            want[i, :29] = np.load(p)
        check(np.array_equal(out, want), "F3: load_clip_batch differs from np.load")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            native.load_clip_batch(paths, 30, 96, 96, nthreads=4)
            times.append(time.perf_counter() - t0)
    rate = F3_CLIPS / statistics.median(times)
    print(f"phase F3 native runtime built in {build_s:.1f} s "
          f"({native.library_path().name}); levenshtein_native == levenshtein "
          f"on {len(pairs)} pairs; load_clip_batch of {F3_CLIPS} clips "
          f"(29,96,96) uint8 == np.load, {rate:.0f} clips/s at 4 threads (warm "
          f"page cache); Lrw1000Dataset and its audio stream: CPU tests only "
          f"(no OpenCV on this machine)")
    return dict(build_s=build_s, pairs=len(pairs), clips_per_s=rate)


def _bf16_rows(rows):
    return {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "module_ms", "bound_ms",
                                          "max_abs_err")}
            for r in rows if r["dtype"] == "bfloat16"}


def _eval_turn(target, torch, np, dev) -> dict:
    """Phase 3d: K9-K11 checked and timed."""
    _, k10, k11 = target.phase_eval_kernels(torch, np, dev)
    return dict(fused_resblock=_bf16_rows(k10), fused_decoder_layer=_bf16_rows(k11))


def _bn_turn(target, torch, np, dev) -> dict:
    """Phase 3c: K6-K8 checked and timed at the entry point's shapes."""
    _, stats = target.phase_ingest_bn_kernels(torch, np, dev)
    keys = ("k7_ms", "k8_ms", "k7_bound", "k8_bound", "k7_lib_ms", "k8_lib_ms",
            "k7_err", "k8_err", "per_step")
    return dict(bn={f"{r['case']} {r['dtype']}": {k: r[k] for k in keys} for r in stats})


def _ingest_mask_turn(target, torch, np, dev) -> dict:
    """Phase 3b (K3-K5 checked and timed at the train step's shapes) and
    phase 3c's K6 rows (a tree without ``phase_ingest_kernels`` runs its
    whole phase 3c)."""
    train = target.phase_train_kernels(torch, dev)
    if hasattr(target, "phase_ingest_kernels"):
        ingest = target.phase_ingest_kernels(torch, np, dev)
    else:
        ingest = target.phase_ingest_bn_kernels(torch, np, dev)[0]
    # K5 queued and the launch floor by this file's timers, the same for
    # both trees (the tree's package is the one its phases imported)
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    keys = ("mask_ms", "mask_bound", "fwd_ms", "bwd_ms")
    rows = {}
    for r in train:
        rows[f"{r['case']} {r['dtype']}"] = row = {k: r.get(k) for k in keys}
        if r["dtype"] == "bfloat16" and r["case"] in MASK_TIMED:
            row["mask_queued_ms"] = k5_queued_ms(torch, ops, dev, MASK_TIMED[r["case"]])
    return dict(train=rows, launch_floor=launch_floor(torch, dev),
                ingest={f"{r['case']} {r['dtype']}": {k: r[k] for k in ("ms", "bound_ms",
                                                                        "plain_ms")}
                        for r in ingest})


# phase sets of the A/B turns: (the turn's phases, the summary of its runs)
def _eval_summary(runs):
    return {f"{kernel} {case}": {lab: [r[kernel][case]["ms"] for r in runs
                                       if r["label"] == lab]
                                 for lab in ("parent", "change")}
            for kernel in ("fused_resblock", "fused_decoder_layer")
            for case in runs[0][kernel]}


def _bn_summary(runs):
    """Each kernel's ms per case both trees time (bf16 and f32), and the
    bf16 sums per B=240 step."""
    def side(lab, fn):
        return [fn(r) for r in runs if r["label"] == lab]
    summary = {}
    cases = [c for c in runs[0]["bn"] if all(c in r["bn"] for r in runs)]
    for kernel in ("k7", "k8"):
        for case in cases:
            summary[f"{kernel} {case}"] = {
                lab: side(lab, lambda r: r["bn"][case][f"{kernel}_ms"])
                for lab in ("parent", "change")}
            summary[f"{kernel} {case}"]["bound_ms"] = runs[0]["bn"][case][f"{kernel}_bound"][0]
        summary[f"{kernel} per B=240 step bfloat16"] = {
            lab: side(lab, lambda r: sum(v[f"{kernel}_ms"] * v["per_step"]
                                         for c, v in r["bn"].items()
                                         if c.endswith("bfloat16")))
            for lab in ("parent", "change")}
    return summary


def _ingest_mask_summary(runs):
    """K6's ms per dtype, and K5's, K3's and K4's ms per train-step case
    and dtype, of each tree's turns, beside this tree's bounds."""
    def side(lab, fn):
        return [fn(r) for r in runs if r["label"] == lab]
    change = next(r for r in runs if r["label"] == "change")
    summary = {}
    for case in change["ingest"]:
        if all(case in r["ingest"] for r in runs):
            summary[f"ingest_train {case}"] = dict(
                {lab: side(lab, lambda r: r["ingest"][case]["ms"]) for lab in ("parent", "change")},
                bound_ms=change["ingest"][case]["bound_ms"])
    for key, kernel in (("mask_ms", "dropout_keep_mask_flat"),
                        ("fwd_ms", "small_mha_dropout_fwd_flat"),
                        ("bwd_ms", "small_mha_dropout_bwd_flat")):
        for case in change["train"]:
            if all(case in r["train"] for r in runs):
                summary[f"{kernel} {case}"] = {
                    lab: side(lab, lambda r: r["train"][case][key])
                    for lab in ("parent", "change")}
                if key == "mask_ms":
                    summary[f"{kernel} {case}"]["bound_ms"] = (
                        change["train"][case]["mask_bound"][0])
                if key == "mask_ms" and "mask_queued_ms" in change["train"][case]:
                    summary[f"{kernel} {case} queued"] = {
                        lab: side(lab, lambda r: r["train"][case]["mask_queued_ms"])
                        for lab in ("parent", "change")}
    for part in ("fill_ms", "empty_ms", "queued_fill_ms"):
        summary[f"launch floor {part}"] = {
            lab: side(lab, lambda r: r["launch_floor"][part]) for lab in ("parent", "change")}
    return summary


PHASE_SETS = {"eval": (_eval_turn, _eval_summary), "bn": (_bn_turn, _bn_summary),
              "ingest_mask": (_ingest_mask_turn, _ingest_mask_summary)}


def turn_child(phase_set: str, tree: str) -> dict:
    """One checkout's phases of a set, by its own chip_smoke.py (in a
    process of its own, with the checkout first on sys.path)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as target
    if not Path(target.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"chip_smoke came from {target.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    target.phase_build()
    return dict(tree=tree, **PHASE_SETS[phase_set][0](target, torch, np, dev))


def compare_turns(phase_set: str, parent: str) -> int:
    """A phase set in PARENT_DIR and in this checkout, in turns (parent,
    change, change, parent); logs and JSON in chiprun_out/compare_<set>*."""
    change = str(Path(__file__).resolve().parent)
    out = Path(change) / "chiprun_out"
    out.mkdir(exist_ok=True)
    runs = []
    for turn, (label, tree) in enumerate((("parent", parent), ("change", change),
                                          ("change", change), ("parent", parent))):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--turn-child", phase_set, tree], cwd=tree,
                             capture_output=True, text=True, timeout=900, check=False)
        (out / f"compare_{phase_set}_{label}{turn}.log").write_text(res.stdout + res.stderr)
        check(res.returncode == 0, f"{label} turn in {tree} failed:\n{res.stderr[-2000:]}")
        run = dict(json.loads(res.stdout.strip().splitlines()[-1]), label=label)
        print(json.dumps(run), flush=True)
        runs.append(run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=False).stdout.strip()
    summary = dict(PHASE_SETS[phase_set][1](runs), card=smi)
    (out / f"compare_{phase_set}.json").write_text(json.dumps(dict(runs=runs, summary=summary)))
    print(smi)
    print(json.dumps(summary))
    return 0


AVSR_BATCH = 4
AVSR_LENGTHS = (155, 38, 97, 120)
# f32 (TF32 off) against the reference: summation order only
AVSR_F32_TOL = {"ctc_logit_err": 2e-3, "step_logit_err": 2e-3, "ctc_prefix_err": 2e-2,
                "ctc_prefix_self": 2e-2, "frontier_self": 1e-3, "dup_hyps": 0,
                "order_off": 0}
AVSR_KERNEL_BATCH = 64


def avsr_kernel_checks(torch, dev):
    """K12 and K1 against their plain versions at the shapes the auto_avsr
    path gives them, B = AVSR_KERNEL_BATCH utterances padded to T frames:
    K12 as the Conformer's relative-position self-attention, (B, 12, T, 64)
    with a per-head f32 bias of the rel-shifted positional term and
    MASK_FILL at the padded keys; K1 as the beam's cross-attention, the 40
    hypotheses of an utterance as query rows over its T padded frames."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C, ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models.conformer import rel_shift
    from sbl_for_multilingual_lip_reading_tpu_torch.ops.masks import \
        key_pad_mask_from_lengths
    cfg = C.auto_avsr_vsr()
    B, H, d, K = AVSR_KERNEL_BATCH, cfg.dims.n_head, cfg.dims.d_k, cfg.conformer.beam_size
    scale = 1.0 / d ** 0.5
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for T in (max(AVSR_LENGTHS), min(AVSR_LENGTHS)):
        lengths = torch.randint(min(AVSR_LENGTHS), T + 1, (B,), generator=g, device=dev)
        lengths[0] = T
        pad = key_pad_mask_from_lengths(lengths, T)                       # (B, 1, T)
        key_bias = ops.mask_to_bias(pad, 1, T)[:, None]                   # (B, 1, 1, T)
        qv = torch.randn((B, H, T, d), generator=g, device=dev)
        p = torch.randn((H, d, 2 * T - 1), generator=g, device=dev)
        rel = torch.add(key_bias, rel_shift(torch.matmul(qv, p)), alpha=scale).contiguous()
        mem_bias = ops.mask_to_bias(pad, K, T)                            # (B, K, T)
        for dt in (torch.float32, torch.bfloat16):
            name_dt = str(dt).split(".")[-1]
            q, k, v = (torch.randn((B, H, T, d), generator=g, device=dev, dtype=dt)
                       for _ in range(3))
            got = ops.fused_mha(q, k, v, rel, scale)
            want = ops.fused_mha_plain(q, k, v, rel, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= K1_TOL[name_dt] and bool(torch.isfinite(got).all()),
                  f"11a K12 rel-pos ({B},{H},{T},{d}) {name_dt}: max abs err {err}")
            out[f"K12 T={T} {name_dt}"] = err
            q = torch.randn((B, K, H * d), generator=g, device=dev, dtype=dt)
            k, v = (torch.randn((B, T, H * d), generator=g, device=dev, dtype=dt)
                    for _ in range(2))
            got = ops.small_mha_flat(q, k, v, H, bias=mem_bias)
            want = ops.small_mha_flat_plain(q, k, v, H, bias=mem_bias)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= K1_TOL[name_dt] and bool(torch.isfinite(got).all()),
                  f"11a K1 beam cross ({B},{K})x({B},{T}) {name_dt}: max abs err {err}")
            out[f"K1 T={T} {name_dt}"] = err
            del q, k, v, got, want
    print(f"11a kernels: {json.dumps(out)}", flush=True)
    return out


def phase_auto_avsr(torch, np, dev):
    """Phase 11a (see the module's doc)."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C, ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
    from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import \
        make_ctc_attention_beam_decoder
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from port_bench.core import judge_ctc
    root = Path(__file__).resolve().parent
    model_cfg = json.loads((root / "port_bench/configs/auto_avsr_vsr.json").read_text())["model"]
    limits = json.loads((root / "port_bench/limits/auto_avsr_vsr.ctcbeam40.b64.json").read_text())
    out = {"kernels": avsr_kernel_checks(torch, dev)}
    g = torch.Generator(device=dev).manual_seed(11)

    def clips_of(lengths):
        T = max(lengths)
        x = torch.randint(0, 256, (len(lengths), T, 96, 96), generator=g, device=dev,
                          dtype=torch.uint8)
        for i, n in enumerate(lengths):
            x[i, n:] = 0
        return x, torch.tensor(lengths, device=dev)

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(C.auto_avsr_vsr(), compute_dtype=dtype)
        model = build_model(cfg, device=dev)
        with torch.no_grad():      # no BatchNorm or LayerNorm left an identity
            for name, t in model.state_dict().items():
                if name.endswith(("running_mean", "bias")) and t.dim() == 1:
                    t.add_(0.1 * torch.randn(t.shape, generator=g, device=dev))
                elif name.endswith("running_var"):
                    t.mul_(torch.exp(0.2 * torch.randn(t.shape, generator=g, device=dev)))
        clips, lengths = clips_of(list(AVSR_LENGTHS[:AVSR_BATCH]))
        beam = make_ctc_attention_beam_decoder(model, cfg)
        rows = (int(lengths.argmax()), int(lengths.argmin()))
        seen, ctc = {r: [] for r in rows}, {}
        beam.watch = lambda rec: [seen[r].append(judge_ctc.row_of(rec, r, beam.K))
                                  for r in rows]
        log_probs = model.ctc_log_probs

        def watched(enc):
            lp = log_probs(enc)
            ctc.update({r: lp[r].float() for r in rows})
            return lp
        model.ctc_log_probs = watched
        video = device_ingest(clips, cfg.data.crop_size, model.frontend.dtype,
                              n_frames=lengths, mean=cfg.data.mean, std=cfg.data.std)
        ops.reset_launch_counts()
        k13 = ops.cached_attention_step
        k13.launches = k13.slots = 0
        toks, scores = beam(video, lengths)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        want = {"stack_frames": 1, "fused_mha": cfg.dims.n_enc_layers,
                "small_mha_flat": cfg.dims.n_dec_layers * cfg.decoder.maxlen}
        check(launches == want, f"11a {dtype}: launches {launches}, want {want}")
        # K13: a launch a decoder layer and step, each over the N hypotheses'
        # slots 0..step
        steps, N = cfg.decoder.maxlen, len(lengths) * beam.K
        want13 = (cfg.dims.n_dec_layers * steps,
                  cfg.dims.n_dec_layers * N * steps * (steps + 1) // 2)
        check((k13.launches, k13.slots) == want13,
              f"11a {dtype}: K13 launches, slots {(k13.launches, k13.slots)}, want {want13}")
        out["k13_launches"] = k13.launches
        check(bool((scores[:, 1:] <= scores[:, :-1]).all()), f"11a {dtype}: order")
        model.ctc_log_probs = log_probs
        # the benchmark's judge, on the two utterances alone at their lengths
        utterances = [judge_ctc.utterance(clips[r, :int(lengths[r])], toks[r], scores[r],
                                          ctc[r][:int(lengths[r])], seen[r]) for r in rows]
        state = {k: v.float() for k, v in model.state_dict().items()}
        err = judge_ctc.judge(dict(model_cfg, compute_dtype=dtype), state, utterances, dev)
        tol = AVSR_F32_TOL if dtype == "float32" else {
            k: v["limit"] for k, v in limits.items() if k in err}
        for k, t in tol.items():
            check(err[k] <= t, f"11a {dtype}: {k} {err[k]:.3g} > {t}")
        out[dtype] = dict(err, launches=launches)
        print(f"11a {dtype}: {json.dumps(out[dtype])}", flush=True)
        del model, beam
        _release(torch)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--turn-child"]:
        print(json.dumps(turn_child(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on the card", file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(torch, np, dev, int(sys.argv[2]), int(sys.argv[3]),
                         sys.argv[4])
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(torch, np, dev, sys.argv[2], int(sys.argv[3]),
                         int(sys.argv[4]), sys.argv[5])
    if sys.argv[1:2] == ["--auto-avsr"]:
        smi, name = phase_card(torch)
        phase_build()
        k13 = phase_cached_attention(torch, dev)
        avsr = phase_auto_avsr(torch, np, dev)
        print(json.dumps({"auto_avsr": avsr, "cached_attention_step": k13, "card": smi}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    compare = {"--compare-eval": "eval", "--compare-bn": "bn",
               "--compare-ingest-mask": "ingest_mask"}
    if sys.argv[1:2] and sys.argv[1] in compare:
        return compare_turns(compare[sys.argv[1]], str(Path(sys.argv[2]).resolve()))
    _set_switches(False)

    t_start = time.perf_counter()

    def timed(phase, fn, *args):
        """Run one phase and print its wall time on the host clock."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
        return out

    smi, name = phase_card(torch)
    timed("2", phase_build)
    kernels = timed("3", phase_kernels, torch, dev)
    train_kernels = timed("3b", phase_train_kernels, torch, dev)
    ingest, stats = timed("3c", phase_ingest_bn_kernels, torch, np, dev)
    twins = timed("3e", phase_twin_kernels, torch, dev)
    k13 = timed("3f", phase_cached_attention, torch, dev)
    launches = timed("4", phase_slice, torch, np, dev)
    tiny = timed("4b", phase_tiny, torch, np, dev)
    train_launches, train = timed("5", phase_train, torch, np, dev)
    entry_launches, entry = timed("6", phase_entry, torch, np, dev)
    k9, k10, k11 = timed("3d", phase_eval_kernels, torch, np, dev)
    a_launches, path_a = timed("7", phase_path_a, torch, np, dev)
    b_launches, path_b = timed("8", phase_path_b, torch, np, dev)
    b_k13 = {f"uni_eval {k}": v for k, v in path_b["k13_launches"].items()}
    c_launches, path_c = timed("9", phase_path_c, torch, np, dev)
    d_launches, path_d = timed("10", phase_path_d, torch, np, dev)
    path_e = dict(remat=timed("E1", phase_remat, torch, np, dev),
                  grad_clip=timed("E2", phase_grad_clip, torch, np, dev),
                  dp_one=timed("E3", phase_dp_one, torch, np, dev),
                  dp_two=timed("E4", phase_dp_two, torch, np, dev))
    e_launches, path_e["cli"] = timed("E5", phase_path_e_cli, torch, np, dev)
    path_e["memorize"] = timed("E6", phase_memorize, torch, np, dev)
    tp_launches, path_e["tp"] = timed("E7", phase_tp, torch, np, dev)
    tpt_launches, path_e["tp_trainer"] = timed("E8", phase_tp_trainer, torch, np, dev)
    fused_launches, path_e["fused"] = timed("E9", phase_fused, torch, np, dev)
    switches = dict(bn_variants=timed("F1", phase_bn_variants, torch, np, dev))
    f2_launches, switches["steps"] = timed("F2", phase_switch_steps, torch, np, dev)
    switches["native"] = timed("F3", phase_native, torch, np, dev)
    avsr = timed("11a", phase_auto_avsr, torch, np, dev)
    print(f"phases 1-10, E1-E9, F1-F3 and 11a took {time.perf_counter() - t_start:.1f} s")
    # every kernel of the eval and training paths was launched on its path
    for kernel in ("stack_frames_u8", "fused_resblock", "fused_decoder_layer",
                   "small_mha_flat"):
        check(a_launches[kernel] > 0, f"path A never launched {kernel}")
    for kernel in ("small_mha_flat", "stack_frames"):
        check(b_launches[kernel] > 0, f"path B never launched {kernel}")
    for kernel in ("small_mha_dropout_fwd_flat", "small_mha_dropout_bwd_flat"):
        check(c_launches[kernel] > 0, f"path C never launched {kernel}")
    for kernel in ("small_mha_flat", "stack_frames", "small_mha_dropout_fwd_flat",
                   "small_mha_dropout_bwd_flat"):
        check(d_launches[kernel] > 0, f"path D never launched {kernel}")
    for kernel in ("stack_frames", "small_mha_dropout_fwd_flat",
                   "small_mha_dropout_bwd_flat", "ingest_train", "channel_sums",
                   "channel_sums_pair", "small_mha_flat"):
        check(e_launches[kernel] > 0, f"path E never launched {kernel}")
    for kernel in ("stack_frames", "small_mha_dropout_fwd_flat",
                   "small_mha_dropout_bwd_flat", "ingest_train", "channel_sums",
                   "channel_sums_pair"):
        check(tp_launches[kernel] > 0, f"the tensor-parallel step never launched "
              f"{kernel}")
    for kernel in ("small_mha_dropout_fwd_flat", "small_mha_dropout_bwd_flat",
                   "small_mha_flat", "fused_decoder_layer"):
        check(tpt_launches[kernel] > 0, f"the tensor-parallel Trainer never "
              f"launched {kernel}")
    for kernel in ("stack_frames", "small_mha_dropout_fwd_flat",
                   "small_mha_dropout_bwd_flat", "ingest_train", "channel_sums",
                   "channel_sums_pair"):
        check(fused_launches[kernel] > 0, f"the epoch-fused route never "
              f"launched {kernel}")
    by_path = {"recognize": launches, "train_step": train_launches,
               "entry_point": entry_launches, "eval_switches": a_launches,
               "uni_eval": b_launches, "uni_train": c_launches,
               "classify": d_launches, "path_e": e_launches,
               "tp_step": tp_launches, "tp_trainer": tpt_launches,
               "fused_route": fused_launches,
               **{f"switch_step_{k}": v for k, v in f2_launches.items()}}

    csrc = "sbl_for_multilingual_lip_reading_tpu_torch/csrc/"
    jax_ops = "sbl_for_multilingual_lip_reading_tpu/ops/"

    def row(kernel, source, replaces, head, err, cases, **extra):
        return {"name": kernel, "route": "cuda", "source": csrc + source,
                "replaces": jax_ops + replaces,
                "launches": max(p[kernel] for p in by_path.values()),
                "launches_by_path": {k: p[kernel] for k, p in by_path.items()},
                "max_abs_err": err, "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "library_call": head["library_call"], "case": head["case"],
                "cases": cases, **extra}

    rows = []
    # K1, K2: the headline row is the busiest bf16 shape of the recognize path
    for kernel, source, replaces, headline in (
            ("small_mha_flat", "attention.cu", "attention.py:573",
             "decoder self (1024,17,512) causal"),
            ("stack_frames", "stem.cu", "stem.py:39", "stem (512,30,88,88)")):
        head = next(r for r in kernels[kernel]
                    if r["case"] == headline and r["dtype"] == "bfloat16")
        rows.append(row(kernel, source, replaces, head,
                        max(r["max_abs_err"] for r in kernels[kernel]
                            if r["dtype"] == "bfloat16"
                            and not r["case"].startswith("extra")),
                        kernels[kernel]))
    # K3, K4, K5: the headline row is the decoder self-attention in bf16;
    # K5 draws the mask K3/K4 draw inline, so no path launches it (it serves
    # the card check)
    bf16 = [r for r in train_kernels if r["dtype"] == "bfloat16"]
    head = next(r for r in bf16 if r["case"] == "decoder self (480,17,512) causal")
    for kernel, replaces, key in (
            ("small_mha_dropout_fwd_flat", "attention.py:724", "fwd"),
            ("small_mha_dropout_bwd_flat", "attention.py:774", "bwd"),
            ("dropout_keep_mask_flat", "attention.py:874", "mask")):
        lib = (head.get(f"{key}_lib_ms"), head.get(
            f"{key}_lib_call", "none: no PyTorch call draws this Philox mask"))
        h = dict(case=head["case"], ms=head[f"{key}_ms"],
                 plain_ms=head[f"{key}_plain_ms"],
                 bound_ms=head[f"{key}_bound"][0], bound_by=head[f"{key}_bound"][1],
                 library_ms=lib[0], library_call=lib[1])
        rows.append(row(kernel, "attention_train.cu", replaces, h,
                        max(r[f"{key}_err"] for r in bf16) if key != "mask" else 0.0,
                        [{k: r[k] for k in ("case", "dtype", f"{key}_ms",
                                            f"{key}_plain_ms")}
                         for r in train_kernels],
                        on_main_path=kernel != "dropout_keep_mask_flat",
                        **({"queued_ms": head["mask_queued_ms"],
                            "launch_floor": head["launch_floor"]} if key == "mask" else {})))
    # K6 at its one shape; K7, K8: the headline row is the stem's BatchNorm
    # in bf16, and per_step_ms sums the frontend's 20 launches per step
    rows.append(row("ingest_train", "ingest.cu", "ingest.py:50",
                    next(r for r in ingest if r["dtype"] == "bfloat16"), 0.0,
                    ingest))
    bn16 = [r for r in stats if r["dtype"] == "bfloat16"]
    stem = next(r for r in bn16 if r["case"].startswith("stem"))
    for kernel, replaces, key in (("channel_sums", "batchnorm.py:65", "k7"),
                                  ("channel_sums_pair", "batchnorm.py:101", "k8")):
        h = dict(case=stem["case"], ms=stem[f"{key}_ms"],
                 plain_ms=stem[f"{key}_plain_ms"], bound_ms=stem[f"{key}_bound"][0],
                 bound_by=stem[f"{key}_bound"][1], library_ms=stem[f"{key}_lib_ms"],
                 library_call=stem[f"{key}_lib_call"])
        rows.append(row(
            kernel, "batchnorm.cu", replaces, h,
            max(r[f"{key}_err"] for r in stats),
            [{k: r[k] for k in ("case", "dtype", f"{key}_err", f"{key}_ms",
                                f"{key}_plain_ms", f"{key}_lib_ms")}
             for r in stats],
            per_step_ms=sum(r[f"{key}_ms"] * r["per_step"] for r in bn16),
            per_step_plain_ms=sum(r[f"{key}_plain_ms"] * r["per_step"] for r in bn16),
            per_step_bound_ms=sum(r[f"{key}_bound"][0] * r["per_step"] for r in bn16),
            max_rel_err_of_abs_sum=max(r[f"{key}_err"] for r in stats)))
    # K9, K10, K11: the headline rows are bf16 at the path's shapes (K10:
    # layer1's, the largest plane; K11: the widest segment with its bias);
    # per_batch_ms sums a kernel's launches over one path A batch
    rows.append(row("stack_frames_u8", "stem.cu", "stem.py:65",
                    next(r for r in k9 if r["dtype"] == "bfloat16"), 0.0, k9))
    rb16 = [r for r in k10 if r["dtype"] == "bfloat16"]
    path16 = [r for r in rb16 if r["per_batch"]]
    rows.append(row(
        "fused_resblock", "resblock.cu", "resblock.py:53", rb16[0],
        max(r["max_abs_err"] for r in rb16), k10,
        per_batch_ms=sum(r["ms"] * r["per_batch"] for r in path16),
        per_batch_module_ms=sum(r["module_ms"] * r["per_batch"] for r in path16),
        per_batch_bound_ms=sum(r["bound_ms"] * r["per_batch"] for r in path16)))
    dl16 = [r for r in k11 if r["dtype"] == "bfloat16"]
    head = next(r for r in dl16 if r["case"].startswith("L=17 causal"))
    rows.append(row(
        "fused_decoder_layer", "decoder_layer.cu", "decoder_layer.py:159", head,
        max(r["max_abs_err"] for r in dl16), k11, module_ms=head["module_ms"]))
    # the layout twins and K12: no model path of either package calls them,
    # so they launch on no path (0 everywhere); the headline rows are bf16 at
    # the decoder's shapes (the dropout mask's at the decoder's, K12 at
    # (512,8,17,64) with the per-head bias)
    for kernel, source, replaces, headline in (
            ("fused_small_mha", "attention.cu", "attention.py:493",
             f"({2 * SLICE_BATCH},17,8,64) causal"),
            ("small_mha_bwd", "attention_train.cu", "attention.py:156",
             f"({2 * TRAIN_BATCH},17,8,64) causal"),
            ("small_mha_dropout_fwd", "attention_train.cu", "attention.py:286",
             f"({2 * TRAIN_BATCH},17,8,64) causal"),
            ("small_mha_dropout_bwd", "attention_train.cu", "attention.py:334",
             f"({2 * TRAIN_BATCH},17,8,64) causal"),
            ("dropout_keep_mask", "attention_train.cu", "attention.py:404",
             f"({2 * TRAIN_BATCH},8,17,17)"),
            ("fused_mha", "attention.cu", "attention.py:56",
             f"({SLICE_BATCH},8,17,64) per-head bias")):
        rs = twins[kernel]
        head = next(r for r in rs if r["case"] == headline
                    and r["dtype"] == "bfloat16")
        rows.append(row(kernel, source, replaces, head,
                        max(r["max_abs_err"] for r in rs if r["dtype"] == "bfloat16"),
                        rs, on_main_path=False))
    # K13: not in ops.KERNELS, so its launches are its own count, read by
    # phase 8 (the lrw1000 decoders) and 11a (the CTC beam); the headline
    # row is the CTC beam's at step L // 2 in bf16
    head = next(r for r in k13["rows"] if r["case"] == K13_SHAPES[0][0]
                and r["dtype"] == "bfloat16" and r["step"] == K13_SHAPES[0][2] // 2)
    rows.append({"name": "cached_attention_step", "route": "cuda",
                 "source": csrc + "decode_attention.cu",
                 "replaces": "none: MultiHeadAttention.decode_step's einsums",
                 "launches": max(b_k13.values()),
                 "launches_by_path": dict(b_k13, ctc_beam=avsr["k13_launches"]),
                 "max_abs_err": max(r["max_abs_err"] for r in k13["rows"]
                                    if r["dtype"] == "bfloat16"),
                 **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_call", "case")},
                 "per_batch": k13["per_batch"], "cases": k13["rows"]})
    check(len(rows) == 18, "eighteen kernels")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    check(all(k in r for r in rows for k in keys), "a kernel row lacks a key")
    print(json.dumps({"kernels": rows, "card": smi, "train": train,
                      "entry_point": entry, "path_a": path_a, "path_b": path_b,
                      "path_c": path_c, "path_d": path_d, "path_e": path_e,
                      "tiny": tiny, "switches": switches, "auto_avsr": avsr}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
