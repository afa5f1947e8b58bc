#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sgaligner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (every failure raises and exits non-zero):
  device       card name, power limit; TF32 off for f32 products and
               convolutions
  build        nvcc builds the kernels from sgaligner_tpu_torch/csrc
  kernels      each of the fifteen kernels against its plain PyTorch version
               on the card: full width (P=512, C=128, da=32, K=1024, PointNet
               3 -> 64 -> 128 -> 256), O=67 objects (ragged, not a multiple
               of 8), float32 and bfloat16, SA and OA (the six kernels of the
               attention family); again at P=200 (not a multiple of the
               kernels' row tiles); the PointNet forward also at EVA's
               C3 = 200 (bf16: the wrapper pads to the kernel's width and
               drops the padding, with two planted faults, PADDED_PLANTED;
               f32: the kernel takes any C3, F32_FWD_PLANTED); the PointNet
               backward at C3 = 200 and 100 at O = 67 and the EVA retrain's
               O = 256 (bf16: padded to the kernel's multiple of 16, dW3 and
               db3 cropped, with the crop's two planted faults,
               PADDED_BWD_PLANTED; f32: unpadded, F32_BWD_PLANTED). The
               PointNet forward's argmax and the tail's argmax / argmin are
               held by value: at the kernel's index the plain activation must
               equal the plain max (min). Each training and op kernel, the
               tail in both forms and the embedding forwards twice on the
               same inputs: the same bits. Faults planted in the wgmma
               kernels' outputs (KERNEL_PLANTED), each of which the
               comparison must catch. Then the seven kernels at C = 256,
               da = 64 (WIDE: the four block kernels FullPCT runs, eval,
               training forward, epilogue sums, training backward; and the
               two ops' three, the attention forward and backward and the
               block op's backward) at O = 67, P = 256 and 200, f32 and
               bf16, SA and OA, each launching its C = 256 kernel once, the
               same bits twice, the three backwards' KERNEL_PLANTED faults
               caught (at f32 also WIDE_F32_PLANTED in their weight
               gradients). At f32 the tail's faults of TAIL_F32_PLANTED
               (an argmax moved to the next point, a dW column x1.1, a dx
               row tile zeroed) and the f32 C = 128 block and attention
               forms' and embed_second pair's of NARROW_F32_PLANTED (a dx,
               t_out, h1 or dh0 row tile zeroed, dWqk, dWt, dWv, dW1, dwf
               or the sums x1.001, the embeddings' KERNEL_PLANTED too)
               caught at P = 512 and 200
  parity       the pct serving path on the CPU (plain versions) against the
               card (kernels): same seeded weights, one pooled B=8 batch, f32;
               the card's launches in that request (the f32 serving form's row)
  train_parity the point configuration's train step on the CPU against the
               card: same seeded weights, one pooled B=8 batch, f32, three
               steps; every gradient of the first step (worst leaf,
               normwise), the losses per step and the parameters' drift.
               Then the card again with faults planted in the backward
               kernel's output, each of which the checks must catch
  train_pct_parity  the pct configuration's train step on the card at f32
               and on the CPU at f32 and f64: same seeded weights, one
               pooled B=4 batch (O=128), head dropout off, three steps, the
               CPU runs routed through the card's tail argmax / argmin. The
               card must sit no further from the f64 run than PCT_VS_CPU
               times the CPU's f32 run does: every gradient of the first
               step, the losses, the parameters' drift and the BN running
               statistics. Then faults planted in the outputs of the block,
               embedding and tail backward kernels, each of which the checks
               must catch
  oa_parity    SPCT (four OA blocks) in train mode, three Adam steps on a
               seeded-cotangent loss over its three outputs, on the card at
               f32 and on the CPU at f32 and f64 (the pooled B=4 batch,
               O=128), held by train_pct_parity's rule, the first step's
               outputs too; then pct_attention_fused's and pct_block_fused's
               gradients (SA and OA; at C = 128, P = 512 and at C = 256,
               P = 256) on the card against the CPU at f64; then faults
               planted in the OA block backward and the ops' backward
               kernels, each of which a check must catch (the ops' at both
               widths)
  serve        the pct serving configuration of bench.py (B=512 pairs, 32
               object slots per graph, 512 points, bfloat16, pooled bucket
               128): four requests with distinct seeds through
               make_serving_step; launch counts 1/1/4/1 per request
  train        bench.py's point training configuration (B=32, 32 slots,
               P=512, bf16, pooled bucket 128, one synthetic batch, seed 0):
               warm-up, then 3 windows of 20 steps; ms per step, pairs/s,
               1 forward and 1 backward PointNet launch per step, a finite
               loss that falls on the fixed batch
  train_pct    bench.py's pct training configuration (B=32, 32 slots, P=512,
               bf16, pooled bucket 128, O=896, Adam lr 1e-3, head dropout
               0.5, one synthetic batch, seed 0): warm-up, 3 windows of 20
               steps, ms per step, pairs/s, the launches per step of every
               kernel, a torch.profiler pass; then the same at
               compute_dtype float32 (TpuConfig's default dtype; F32_STEP:
               2 windows of 10 steps, 2 profiled), whose tail runs the f32 forms
  serve_point  the point configuration serving the four B=512 requests;
               1 PointNet forward launch per request
  spct         SPCT at full width on bench.py's pct training batch (B=32,
               O=896, bf16): eval forward and train-mode forward plus
               backward, ms per call, launches per call (eval: 4 OA
               pct_block_eval; train: 4/4/4 of the OA block forward, epilogue
               sums and block backward; the embedding kernels)
  ops          pct_attention_fused and pct_block_fused forward plus backward
               through autograd at O=896 (C = 128, bf16), then at FullPCT's
               layout (O = 256, P = C = 256) in f32 and bf16, SA and OA,
               against the plain versions; one launch of each of their
               kernels per call (at C = 256 the _c256 ones)
  full_pct     FullPCT (FPS + KNN grouping, SGModule, four OA blocks at
               C = 256) on scripts/aligner_artifact.py's BENCH layout at
               N = 1,024 points an object: eval and three Adam steps at
               O = 32 on the card at f32 and on the CPU at f32 and f64, the
               CPU replaying the card's FPS and KNN picks, held by
               oa_parity's rule; then O = 256 at f32 and bf16, eval and
               train forward plus backward: ms a call, peak memory, 4
               launches of each C = 256 block kernel a call, finiteness,
               and a torch.profiler pass over two f32 train calls (the
               device's busy share)
  artifact     the serving artifact (serving.py: torch.export with the
               kernels as custom ops) for the card: the pct serving step at
               full width (bf16, B=512, K pinned to the largest of serve's
               pooled O), single and as a queue of ARTIFACT_Q, and the point
               configuration; exported, saved, loaded, and serve's four
               requests run through it (launch counts 1/1/4/1 and 1 a
               request), held to make_serving_step / serve_queue on the same
               prepared batches (integer counts equal, rr_sum and
               alignment_score within ARTIFACT_RTOL), ms a request beside the
               eager step's in turns; a request past the pinned K refused
  register     RANSAC at the reference's size (RANSAC_N correspondences,
               RANSAC_ITERS hypotheses, a known transform, 30% inliers) on
               the card against the CPU on the same draw (transforms within
               REG_TF_ABS, equal inlier counts), timed at float64 (the
               library's precision) and, its inputs cast, float32; a planted
               fault (the card's Kabsch returns Rᵀ) that the check must
               catch; icp_refine card against CPU; and
               Aligner.align(register=True) at the API's defaults (pc_res
               512, 5,000 RANSAC hypotheses) on a synthetic scene pair of
               ALIGN_PTS points an object: RRE < 5 deg, RTE < 0.1, one
               pointnet_fwd launch a call, node matches equal to the CPU's
               and the transform within REG_TF_ABS of it; timed warm
  quality      the three tracked trained snapshots (checkpoints/torch/
               aligner_{point,full,eva}.pth.tar) through the port's tester
               (AlignRegTester on the held-out val workspace each
               checkpoints/aligner_<name>/quality.json pins, rebuilt with the
               port's make_synthetic_workspace; the config as a dict, no
               YAML, no tensorstore): at f32 in the tester's own layout, MRR
               and Hits@1/3/5 each within 0.02 of quality.json, EVA
               below full, pointnet_fwd launched once a batch (C3 = 200 for
               EVA); then at bf16 with pooled bucket 128 (the benchmark's
               serving settings) the same metrics and their gaps, a reading.
               In both runs the first request's PointNet forward inputs
               (O = 256 in the tester's layout, the pooled O at bf16) go
               through the kernel again and are held against its plain
               version at the kernels phase's tolerances. Then the full
               snapshot's AlignRegTester with registration (the classical
               backend) over the val split at f32, on the card and on the
               CPU: each metric of the normal and aligner summaries within
               REG_SUMMARY_ABS. The workspace's view noise leaves no point
               of one side within the tester's 1e-7 of the other, so no
               pair has GT correspondences and recall is 0 by construction
               (the phase counts them and says so)
  downstream   the learned registration backend (reg_model.backend: learned,
               checkpoints/torch/geo_reg.pth.tar) on the card, held to
               tests/test_learned_reg.py's floors: full SO(3) (3 pairs, seed
               321, >= 2 within 5 deg / 10 cm), eval_geo's bands 0.2 / 0.3 /
               0.4 (8 pairs each, seed 999: hits at 0.3 + 0.4 >= 13, RR >=
               0.75 at both, RTE of the hits <= 0.04 at 0.4, hits at 0.2 >=
               5) and planar rooms (16 pairs at 0.3, seed 424,242, >= 13
               hits); the 0.4 band's 8 pairs again on the card and on the
               CPU with the same draws (the same hits, transforms within
               GEO_TF_ABS), with register_batch's stage timers in ms a pair;
               batched RANSAC over sets that repeat points, card against
               CPU (RANSAC_REPEAT: the same scores, the degenerate minimal
               sets the identity on both). Then scripts/downstream_quality.py's contract through the
               port's two CLIs on the card: the val workspace (seed 2002) of
               32 overlapping and 32 non-overlapping pairs, the full snapshot
               at f32, overlap P/R/F1 by alignment score and by
               registration score, mosaicking acc / comp / prec / recall /
               fscore over 8 scans, pointnet_fwd launched once an eval batch
               and once a mosaicked subscan (its first request held against
               its plain version); and on an 8 + 8 workspace of the same
               seed with 2 scans, the card's tables (the CPU's come from a
               child process started at the phase's start; see
               downstream_cpu)
  trainer      the EVA recipe of scripts/aligner_artifact.py (its train
               and val workspace, seeds 1001 and 2002; 40 epochs of Adam at
               1e-3, batch 8, f32, the tester's layout) retrained through
               trainval_eva's train function and the port's Trainer: 20
               epochs, then a new Trainer resumed from the rolling snapshot
               to 40; the port's tester on best_snapshot.pth.tar must read
               MRR >= 0.96 and Hits@1 >= 0.95 (RETRAIN_FLOORS); pointnet_bwd
               launched once a step (C3 = 200), pointnet_fwd once a step and
               once a val batch. Then the pct configuration (bf16, pooled
               bucket 128) for 2 epochs through the same Trainer: finite
               losses, every kernel's launches the per-step and per-request
               counts, the final snapshot read back by the tester
  downstream_cpu
               the downstream cut's CPU tables, from the child process the
               downstream phase started (this script with --downstream-cpu,
               no card), against the card's within
               tests/test_downstream_quality.py's tolerances
  dp           data parallel (parallel/mesh.py), two ranks started by
               parallel.launch.run_ranks: NCCL across two cards where the
               machine has them, else gloo with both ranks on the one card
               (the phase prints which); every run against one rank on the
               same per-rank pooled layout. Three f32 Adam steps of the pct
               configuration at full width (32 slots, 512 points, bucket 128,
               B = 32, 16 a rank): every reading within DP_VS_CPU times the
               larger of the CPU's own f32 dp = 2 against dp = 1 reading
               (B = 4, two a rank) and the card's one-rank reading with the
               rows pooled in the other order, the tail picks replayed from
               the one-rank runs; one block's sums left local (DP_PLANTED)
               caught; the ranks' parameters and running statistics
               bit-equal. One bf16 B = 512 request split over the ranks
               against the one-rank request (counts exact, rr_sum and
               alignment_score within DP_SERVE_RTOL); ms a bf16 step and a
               request at dp = 2 and dp = 1, readings; every kernel's
               launches per rank
  time         each kernel against its plain version (and torch.matmul for
               the tail): the pct serving kernels at the serving O (the three
               wgmma kernels beside the replaced WMMA design's times and their
               bounds, the block's three passes under torch.profiler), the pct
               training and PointNet kernels at the training O (the PointNet
               forward also at the serving O, embed_second also at the
               training O; the redesigned training kernels and the PointNet
               backward beside their earlier times, with their passes under
               torch.profiler; the PointNet backward's routed rows beside the
               row tiles its kernel ran, which must be the ones they fill),
               the ops' kernels and the OA variants at O=896, the C = 256
               block kernels (OA) at FullPCT's O = 256, bf16 and f32, the
               ops' C = 256 kernels (SA and OA) at O = 256, P = 256, bf16
               and f32, with their launches in ops, the PointNet
               forward at EVA's C3 = 200 (O = 896 and 13,440; the quality
               runs' request times beside it), the bf16 PointNet backward at
               C3 = 200 beside 208 and 256, and the f32 forms of both PointNet
               kernels at C3 = 200 and 256 beside their first versions'
               times (F32_FIRST_MS) and their passes (O = 256 and 896),
               the other f32 forms at O = 896 beside their plain versions
               and their launches in the parity phases (time_f32_forms; the
               tail's rows, the f32 C = 128 block forms' (rows 5, 6, 9) and
               the f32 embed_second pair's (rows 3, 4) with the launches of
               the f32 serving request and the f32 step windows, the tail's
               and row 3's with one torch.matmul of the product, rows 13's
               and 4's products as torch.matmul calls),
               with each bound
               from the shapes (the PointNet backward's from the rows and
               channels that carry gradient);
               scaled_dot_product_attention(q, q, v) at the serving and
               training shapes, and at C = 256, as a same-work yardstick of
               the attention core

The last two lines are the {"kernels": [...]} record and
{"ok": true, "device": {...}}. Nothing of JAX or of the JAX package is
imported.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger of
# bytes / memory rate and operations / peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

P, C, DA, K = 512, 128, 32, 1024
SA, OA = (True, False), (False, True)   # (scale, double_norm) of the attention ops
PN = (64, 128, 256)            # PointNet widths (conv1, conv2, conv3 = pt_out_dim)
EVA_C3 = 200                   # EVA's PointNet width (models/eva.py); the bf16 wrappers pad it
SMALL_O = 67
RAGGED_P = 200
MODULES = ("pct", "gat", "rel", "attr")
POINT_MODULES = ("point", "gat", "rel", "attr")
TRAIN_B, WARMUP_STEPS, WINDOW_STEPS, N_WINDOWS = 32, 5, 20, 3
F32_STEP = (2, 10, 2)          # the f32 pct step: windows (count, steps), profiled steps

# Normwise tolerance, max|kernel - plain| / max|plain| per output. float32:
# the same f32 arithmetic summed in another order. bfloat16: an output may
# round to the neighbouring bf16 value (2^-8 relative); pct_block_eval also
# exponentiates differently (f32 log-sum-exp in the kernel, bf16 exp against a
# column max in the plain version, as on the TPU). pointnet_bwd, bfloat16:
# its gradients sum O·P products of values that may each sit one bf16 step
# apart, and a relu mask may flip where a pre-activation is near 0.
TOL = {("embed_first", "f32"): 1e-5, ("embed_first", "bf16"): 1e-2,
       ("embed_second", "f32"): 1e-4, ("embed_second", "bf16"): 1e-2,
       ("pct_block_eval", "f32"): 1e-4, ("pct_block_eval", "bf16"): 5e-2,
       ("pct_tail", "f32"): 1e-4, ("pct_tail", "bf16"): 1e-2,
       ("pointnet_fwd", "f32"): 1e-5, ("pointnet_fwd", "bf16"): 1e-2,
       ("pointnet_bwd", "f32"): 1e-4, ("pointnet_bwd", "bf16"): 2e-2,
       # training kernels. Backward sums run over O·P rows; bf16: the same
       # roundings, a relu mask may flip near 0 (embed_second, the block's
       # epilogue). The block forward is pct_block_eval's computation. Its
       # backward at bf16: the bound holds the weight gradients (dWqk, dWv,
       # dbv, dWt, dbt); dx is held by BLOCK_DX_VS_PLAIN below
       ("embed_first_bwd", "f32"): 1e-4, ("embed_first_bwd", "bf16"): 1e-2,
       ("embed_second_bwd", "f32"): 1e-4, ("embed_second_bwd", "bf16"): 2e-2,
       ("pct_block_fwd", "f32"): 1e-4, ("pct_block_fwd", "bf16"): 5e-2,
       ("pct_epi_sums", "f32"): 1e-4, ("pct_epi_sums", "bf16"): 1e-2,
       ("pct_block_res_bwd", "f32"): 1e-4, ("pct_block_res_bwd", "bf16"): 5e-2,
       ("pct_tail_bwd", "f32"): 1e-4, ("pct_tail_bwd", "bf16"): 2e-2,
       # the ops' own kernels: the attention forward is the block's apply
       # without trans; the two backwards are pct_block_res_bwd's passes
       # (their dx at bf16 held by BLOCK_DX_VS_PLAIN too)
       ("pct_attn_fwd", "f32"): 1e-4, ("pct_attn_fwd", "bf16"): 5e-2,
       ("pct_attn_bwd", "f32"): 1e-4, ("pct_attn_bwd", "bf16"): 5e-2,
       ("pct_block_bwd", "f32"): 1e-4, ("pct_block_bwd", "bf16"): 5e-2,
       # OA at bf16: the row normalisation divides by s_j, which amplifies
       # bf16 error where s_j is small; on an H100 the weight gradients of
       # the OA block backward read 3.8e-2 and 5.5e-2 at O = 67 (P = 512,
       # 200) and 3.8e-2 at O = 896, the SA ones up to 3.6e-2 (PERF.md §6)
       ("pct_block_res_bwd/OA", "bf16"): 1e-1,
       # the OA attention backward's gradients read 2.2e-2 at O = 67 and
       # 4.7e-2 at O = 896 (PERF.md §6)
       ("pct_attn_bwd/OA", "bf16"): 1e-1}
# pct_block_res_bwd's dx at bfloat16: the softmax gradient G∘(dY·vᵀ − D)
# cancels, and the kernel and the plain version (bf16 exponentials and bf16
# autograd through them, as the TPU kernel) each sit ≈ 0.18 (normwise) from
# the plain version at f32 on the same inputs, in different directions. So
# the kernel's dx is held to the f32 plain: its distance at most this many
# times the bf16 plain version's own
BLOCK_DX_VS_PLAIN = 1.25
# main path, CPU against the card at float32: relative drift of the joint
# embeddings (the JAX suite measured 0.0077 f32 drift from max-pool ties)
PARITY_DRIFT = 0.02
# point training, CPU against the card at float32, three Adam steps: each
# gradient leaf of the first step, ||card - CPU|| / ||CPU|| (worst leaf); the
# losses' relative difference per step; the parameters' difference relative
# to how far they moved. Sound readings on an H100 (PERF.md): 1.1e-6, 1.0e-7,
# 6.6e-6. The bounds sit between those and the planted faults' readings
# (PLANTED below): the gradient check reads 0.1 to 1 for each of them. The
# loss and parameter checks alone miss some (Adam's first steps move every
# parameter by about lr whatever the gradient's size)
TRAIN_GRAD_DRIFT = 1e-4
TRAIN_LOSS_DRIFT = 1e-6
TRAIN_PARAM_DRIFT = 1e-4
# faults planted in pointnet_bwd's output on the card: (label, gradient
# index (dw1, db1, dw2, db2, dw3, db3), factor)
PLANTED = (("dw3 x2", 4, 2.0), ("db1 zeroed", 1, 0.0), ("dw1 x1.1", 0, 1.1))
# pct training, three Adam steps from the same seeded weights on one B=4
# batch: the card at float32 and the CPU at float32, each against the CPU at
# float64. The pct configuration's BatchNorms fold from one-pass batch
# moments, so float32 rounding alone moves its gradients by about 1e-4 to
# 1e-3 relative (PERF.md); the card is held to PCT_VS_CPU times the CPU's
# own float32 distance, reading by reading (worst gradient leaf, losses,
# parameters against the distance moved, BN running statistics). The tail's
# max / min pool routes each channel's gradient to one point, and where two
# points nearly tie the two sides may pick different ones: both CPU runs
# take the card's argmax / argmin instead, and PCT_INDEX_APART bounds the
# share of (object, channel) indices the CPU's own forward would pick
# otherwise at step 1. On an H100 the card's worst gradient leaf read 2.1,
# 3.1 and 4.5 times the CPU's in three runs (while the embedding kernels
# still added their BN sums with atomics), the other readings 0.5 to 2.8
# times; the planted faults read 600 times and more on the gradient
PCT_VS_CPU = 20.0
PCT_INDEX_APART = 1e-3
# faults planted in the pct backward kernels' outputs: (label, module, wrapper,
# output index, factor)
PCT_PLANTED = (("block dWt x2", "pct_attention", "block_res_bwd", 4, 2.0),
               ("embed_first dW zeroed", "pct_embed", "embed_first_bwd", None, 0.0),
               ("tail dx x1.1", "pct_tail", "pct_tail_bwd", (0, 1, 2, 3), 1.1))
# OA training (SPCT): the same rule as the pct training, reading by reading,
# plus the first step's outputs. Then the two ops' gradients at the parity
# batch's O on the card at f32, against the CPU at f64: no further than
# their backward kernel's f32 tolerance plus PCT_VS_CPU times the CPU's own
# f32 distance. Faults planted in the OA block backward's outputs (SPCT's
# training) and in the ops' backward kernels: (label, wrapper in
# ops/pct_attention.py, output index, factor, the check that runs)
OA_PLANTED = (("block_res_bwd/OA dWv x2", "block_res_bwd", 2, 2.0, "spct"),
              ("block_res_bwd/OA dx x1.1", "block_res_bwd", 0, 1.1, "spct"),
              ("pct_block_bwd dWt x2", "block_bwd", 4, 2.0, "block"),
              ("pct_attn_bwd dx x1.1", "attn_bwd", 0, 1.1, "attention"))
# the tracked trained snapshots (phase quality): each checkpoints/
# aligner_<name> pins its MRR and Hits@k in quality.json, and checkpoints/
# torch/aligner_<name>.pth.tar is its copy in upstream's layout (scripts/
# export_torch_snapshots.py). The benchmark contract of scripts/
# aligner_artifact.py (BENCH, VAL_SEED, N_VAL_PAIRS, write_cfg's values),
# copied so the card rebuilds the val workspace and the config without YAML;
# tests/test_torch_snapshots.py holds it equal to the script and to each
# quality.json. Each metric of the f32 run lies within QUALITY_ABS of
# quality.json, the JAX package's own test's tolerance (tests/
# test_aligner_artifact.py); the bf16 run with the pooled bucket of bench.py
# is a reading only
CHECKPOINTS = REPO / "checkpoints"
BENCH = dict(n_shared=8, n_extra=6, pts_per_obj=256, pc_resolutions=[512],
             view_noise=0.05, bow_flip=0.25, proto_classes=3,
             center_noise=0.75)
VAL_SEED = 2002
N_VAL_PAIRS = 32
MAX_EPOCH = 40
SNAPSHOTS = ("point", "full", "eva")
QUALITY_KEYS = ("mrr", "hits@1", "hits@3", "hits@5")
QUALITY_ABS = 0.02
QUALITY_BUCKET = 128
# aligner_artifact.py's training split and its EVA recipe (CONFIGS["eva"]:
# quality_cfg's values train it, MAX_EPOCH epochs of Adam at a flat 1e-3,
# batch 8, f32), copied for the trainer phase; tests/test_torch_snapshots.py
# holds them equal to the script. The retrain stops at RETRAIN_HALF epochs
# and a new Trainer resumes it. RETRAIN_FLOORS are tests/
# test_aligner_artifact.py's floors for the tracked EVA snapshot
TRAIN_SEED = 1001
N_TRAIN_PAIRS = 96
EVA_RECIPE = dict(modules=["point", "gcn", "rel", "attr"], model_name="eva",
                  epochs=MAX_EPOCH, scheduler="none", lr=1e-3)
RETRAIN_HALF = MAX_EPOCH // 2
RETRAIN_FLOORS = {"mrr": 0.96, "hits@1": 0.95}
PCT_TRAIN_EPOCHS = 2
# objects a batch of the tester's layout carries (8 pairs, 2 graphs, 16
# slots): the EVA retrain's PointNet O
EVA_TRAIN_O = 8 * 2 * 16
# launches per SPCT call at O = 896 (phase spct)
PER_SPCT_EVAL = {"embed_first": 1, "embed_second": 1, "pct_block_eval": 4}
PER_SPCT_TRAIN = {"embed_first": 1, "embed_second": 1, "embed_first_bwd": 1,
                  "embed_second_bwd": 1, "pct_block_fwd": 4, "pct_epi_sums": 4,
                  "pct_block_res_bwd": 4}
SPCT_EVAL_CALLS, SPCT_TRAIN_CALLS = 5, 3
# phase artifact: the serving artifact's components against the eager step's
# on the same batches (the integer counts equal), and the queue's length
ARTIFACT_RTOL = 1e-6
ARTIFACT_Q = 4
# phase register: RANSAC at the reference's size (20k correspondences, 5,000
# hypotheses, 30% inliers), the card against the CPU on the same draw (the
# transforms' largest entry difference, the inlier counts equal), and ICP;
# phase quality: the registration summaries, card against CPU
RANSAC_N, RANSAC_ITERS, RANSAC_INLIERS = 20000, 5000, 0.3
ICP_ITERS = 10
ALIGN_PTS = 1024          # points an object of the scenes align() samples to pc_res 512
REG_TF_ABS = 1e-4
REG_SUMMARY_ABS = 1e-4
# phase downstream: the learned registration backend (checkpoints/geo_reg's
# weights) held to tests/test_learned_reg.py's floors, then the JAX
# package's downstream contract (scripts/downstream_quality.py) through the
# port's two CLIs
GEO_SO3 = dict(seed=321, pairs=3, n_points=2048, overlap=0.6, min_hits=2)
GEO_BANDS = dict(overlaps=(0.2, 0.3, 0.4), n_pairs=8, seed=999)
# hits at 0.3 plus at 0.4, RR at 0.3 and at 0.4, the hits' RTE at 0.4, hits
# at 0.2 (tests/test_learned_reg.py:149-172)
GEO_BAND_FLOORS = dict(hits_mid=13, rr=0.75, rte_hit=0.04, hits_low=5)
GEO_PLANAR = dict(overlaps=(0.3,), n_pairs=16, seed=424_242, scene_kind="room")
GEO_PLANAR_HITS = 13
GEO_TF_ABS = 1e-4          # card against CPU, the 0.4 band's transforms
DOWNSTREAM_MAX_SCANS = 8
# the card against the CPU (tests/test_downstream_quality.py's tolerances)
# on an 8 + 8 workspace of the same seed and 2 scans: the CPU registers a
# pair in seconds, so the full contract on the CPU would take many minutes
# (a 16 + 16 cut took 190 s of the CPU's time on an H100's host, an 8 + 8
# cut 167 s), and the CPU's half runs in a child process (--downstream-cpu)
# beside the card's phases from downstream to trainer
DOWNSTREAM_CPU = dict(pairs=8, scans=2)
# batched RANSAC over sets that repeat points, as the fine stage's do (the
# mosaicking's object pairs: 337 matches of 178 source points): G sets of N
# correspondences, the second half copies of points of the first
RANSAC_REPEAT = dict(seed=15, sets=4, n=256, iters=1000, threshold=0.05)
RANSAC_REPEAT_TF_ABS = 1e-6
DOWNSTREAM_PRF_ABS = 0.05
DOWNSTREAM_DIST_ABS = 0.01     # acc, comp (m)
DOWNSTREAM_RATE_ABS = 0.05     # prec, recall, fscore
# the ops' kernels and the OA variants timed at the training O (phase time):
# (kernel, flags, where its launches were counted)
OA_ROWS = (("pct_attn_fwd", SA, "ops"), ("pct_attn_fwd", OA, "ops"),
           ("pct_attn_bwd", SA, "ops"), ("pct_attn_bwd", OA, "ops"),
           ("pct_block_bwd", SA, "ops"), ("pct_block_bwd", OA, "ops"),
           ("pct_block_eval", OA, "spct_eval"), ("pct_block_fwd", OA, "spct_train"),
           ("pct_block_res_bwd", OA, "spct_train"))

KERNELS = {
    "embed_first": ("sgaligner_tpu_torch/csrc/pct_embed.cu",
                    "sgaligner_tpu/ops/pct_embed.py:46"),
    "embed_second": ("sgaligner_tpu_torch/csrc/pct_embed_sm90.cu",
                     "sgaligner_tpu/ops/pct_embed.py:195"),
    "pct_block_eval": ("sgaligner_tpu_torch/csrc/pct_block_eval_sm90.cu",
                       "sgaligner_tpu/ops/pct_attention.py:833"),
    "pct_tail": ("sgaligner_tpu_torch/csrc/pct_tail_sm90.cu",
                 "sgaligner_tpu/ops/pct_tail.py:83"),
    "pointnet_fwd": ("sgaligner_tpu_torch/csrc/pointnet_sm90.cu",
                     "sgaligner_tpu/ops/pointnet_fused.py:62"),
    "pointnet_bwd": ("sgaligner_tpu_torch/csrc/pointnet_bwd_sm90.cu",
                     "sgaligner_tpu/ops/pointnet_fused.py:72"),
    "embed_first_bwd": ("sgaligner_tpu_torch/csrc/pct_embed_first_bwd.cu",
                        "sgaligner_tpu/ops/pct_embed.py:66"),
    "embed_second_bwd": ("sgaligner_tpu_torch/csrc/pct_embed_bwd_sm90.cu",
                         "sgaligner_tpu/ops/pct_embed.py:221"),
    "pct_block_fwd": ("sgaligner_tpu_torch/csrc/pct_block_eval_sm90.cu",
                      "sgaligner_tpu/ops/pct_attention.py:320"),
    "pct_epi_sums": ("sgaligner_tpu_torch/csrc/pct_epi_sums.cu",
                     "sgaligner_tpu/ops/pct_attention.py:569"),
    "pct_block_res_bwd": ("sgaligner_tpu_torch/csrc/pct_block_bwd_sm90.cu",
                          "sgaligner_tpu/ops/pct_attention.py:599"),
    "pct_tail_bwd": ("sgaligner_tpu_torch/csrc/pct_tail_bwd_sm90.cu",
                     "sgaligner_tpu/ops/pct_tail.py:124"),
    "pct_attn_fwd": ("sgaligner_tpu_torch/csrc/pct_block_eval_sm90.cu",
                     "sgaligner_tpu/ops/pct_attention.py:103"),
    "pct_attn_bwd": ("sgaligner_tpu_torch/csrc/pct_block_bwd_sm90.cu",
                     "sgaligner_tpu/ops/pct_attention.py:108"),
    "pct_block_bwd": ("sgaligner_tpu_torch/csrc/pct_block_bwd_sm90.cu",
                      "sgaligner_tpu/ops/pct_attention.py:341"),
}
# The kernels at C = 256, da = 64 (csrc/pct_attention_c256.cu; the epilogue
# sums csrc/pct_epi_sums.cu): the four block kernels FullPCT's OA blocks run,
# and the two ops' three. Each launch count's name and the wrapper
# (ATTN_FNS, TRAIN_KERNELS) that launches it for a 256-wide input. Their
# tolerances are the C = 128 forms' (TOL)
WIDE = {"pct_block_eval_c256": "pct_block_eval", "pct_block_fwd_c256": "pct_block_fwd",
        "pct_epi_sums_c256": "pct_epi_sums", "pct_block_res_bwd_c256": "pct_block_res_bwd",
        "pct_attn_fwd_c256": "pct_attn_fwd", "pct_attn_bwd_c256": "pct_attn_bwd",
        "pct_block_bwd_c256": "pct_block_bwd"}
WIDE_C, WIDE_P = 256, 256           # FullPCT's OA blocks: C, and P = samples[1]
# phase full_pct: FullPCT on scripts/aligner_artifact.py's BENCH layout (16
# slots a graph, 14 valid objects) at N = 1,024 points an object, so sg1's
# FPS subsamples: 8 pairs, O = 256 on the card at f32 and bf16; the parity
# run (card against CPU, three train steps) takes 1 pair, O = 32
FULL_PCT_N, FULL_PCT_SLOTS, FULL_PCT_VALID, FULL_PCT_PAIRS = 1024, 16, 14, 8
FULL_PCT_SAMPLES = (512, 256)       # FullPCT's own: sg2's 256 centres are the blocks' P
FULL_PCT_PARITY_PAIRS = 1
FULL_PCT_CALLS = 5
WIDE_O = FULL_PCT_PAIRS * 2 * FULL_PCT_SLOTS   # FullPCT's O; the ops' at C = 256 too
PER_FULL_PCT_EVAL = {"pct_block_eval_c256": 4}
PER_FULL_PCT_TRAIN = {"pct_block_fwd_c256": 4, "pct_epi_sums_c256": 4,
                      "pct_block_res_bwd_c256": 4}
PCT_KERNELS = ("embed_first", "embed_second", "pct_block_eval", "pct_tail")
# kernels held to the same bits twice besides the training and op kernels
# (their BN sums: per-block slices, no atomics; the PointNet forward's max
# and argmax; the PointNet backward's per-warpgroup slices)
SAME_BITS = ("embed_first", "embed_second", "pct_tail", "pointnet_fwd", "pointnet_bwd")


def _scaled(index: int, factor: float):
    """A planted fault: output ``index`` times ``factor``."""
    def fault(outs, args):
        return tuple(t * factor if i == index else t for i, t in enumerate(outs))
    return f"output {index} x{factor}", fault


def _moved_argmax(outs, args):
    """A planted fault of the PointNet forward: each channel's index moved
    to the next point (the kernel's own max)."""
    out, amax = outs
    return out, (amax + 1) % args[0].shape[-1]


def _misrouted(outs, args):
    """A planted fault of the PointNet backward: the live channel with the
    largest |dout| routed one point further (the kernel run again)."""
    import torch

    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd

    x, dout, amax, peak, *ws = args
    score = torch.where(peak > 0, dout.float().abs(), torch.zeros_like(peak))
    obj, ch = divmod(int(score.argmax()), dout.shape[1])
    moved = amax.clone()
    moved[obj, ch] = (moved[obj, ch] + 1) % x.shape[-1]
    return pointnet_bwd(x, dout, moved, peak, *ws)


def _tile_scaled(outs, args):
    """A planted fault of the attention forward: the 64-row tile of y that
    holds its largest |value|, times 1.1."""
    y = outs[0].clone()
    obj, row = divmod(int(y.abs().amax(dim=2).argmax()), y.shape[1])
    y[obj, row // 64 * 64:(row // 64 + 1) * 64] *= 1.1
    return (y,)


def _unmasked_sums(outs, args):
    """A planted fault of the embeddings' forwards: the BN sums taken over
    every object, the mask ignored (the kernel's own h)."""
    import torch

    from sgaligner_tpu_torch.ops.pct_embed import masked_sums

    h, mask = outs[0], args[-1]
    return (h, *masked_sums(h, torch.ones_like(mask)))


# faults planted in the redesigned kernels' outputs in the kernels phase
# (bf16, P = 512), each of which the comparison with the plain version must
# catch: (label, fault(outputs, inputs) -> faulty outputs)
KERNEL_PLANTED = {"pct_block_res_bwd": (_scaled(0, 2.0), _scaled(2, 2.0)),
                  "pct_tail_bwd": (_scaled(0, 1.1), _scaled(4, 2.0)),
                  "pct_block_fwd": (_scaled(2, 2.0),),
                  "embed_second": (("sums with the mask ignored", _unmasked_sums),
                                   _scaled(0, 1.1)),
                  "pointnet_fwd": (_scaled(0, 1.1),
                                   ("argmax moved to the next point", _moved_argmax)),
                  "embed_second_bwd": (_scaled(0, 1.1), _scaled(3, 2.0)),
                  "pointnet_bwd": (_scaled(4, 1.1),
                                   ("a live channel routed to the wrong point", _misrouted)),
                  "pct_epi_sums": (_scaled(1, 1.1),),
                  "pct_attn_fwd": (("one 64-row tile of y x1.1", _tile_scaled),),
                  "embed_first_bwd": (_scaled(0, 0.0),),
                  "pct_block_bwd": (_scaled(0, 2.0), _scaled(4, 2.0)),
                  "pct_attn_bwd": (_scaled(0, 2.0), _scaled(2, 2.0))}


def _columns_zeroed(index: int, n0: int, width: int):
    """A planted fault: columns n0 .. n0 + width - 1 of output ``index``
    zeroed (one streamed weight slice of a C = 256 weight gradient lost)."""
    def fault(outs, args):
        outs = list(outs)
        w = outs[index].clone()
        w[..., n0:n0 + width] = 0
        outs[index] = w
        return tuple(outs)
    return f"output {index} columns {n0}..{n0 + width - 1} zeroed", fault


# faults planted in the f32 C = 256 backwards' weight gradients (kernels
# phase, P = 256, besides KERNEL_PLANTED's): the block backwards' dWt second
# 32-column slice (one slice of the dz pass's streamed Wt) lost, the
# attention backward's dWv second 32-column slice lost, and dWqk off by 1e-3
WIDE_F32_PLANTED = {"pct_block_res_bwd": (_columns_zeroed(4, 32, 32), _scaled(1, 1.001)),
                    "pct_block_bwd": (_columns_zeroed(4, 32, 32), _scaled(1, 1.001)),
                    "pct_attn_bwd": (_columns_zeroed(2, 32, 32), _scaled(1, 1.001))}
def _one_amax_moved(outs, args):
    """A planted fault of the tail's indexed forward: the argmax of the
    channel with the largest |max| moved to the next point."""
    outs = list(outs)
    amax = outs[4].clone()
    obj, ch = divmod(int(outs[0].abs().argmax()), amax.shape[1])
    amax[obj, ch] = (amax[obj, ch] + 1) % args[0].shape[1]
    outs[4] = amax
    return tuple(outs)


def _dw_column_scaled(outs, args):
    """The tail backward's dW column holding the largest |value|, x1.1."""
    dw = outs[4].clone()
    dw[:, int(dw.abs().amax(dim=0).argmax())] *= 1.1
    return (*outs[:4], dw)


def _dx_tile_zeroed(outs, args):
    """The 128 flat rows (one row tile of the f32 dx pass) of the dxᵢ that
    holds the largest |value|, zeroed."""
    i = max(range(4), key=lambda j: float(outs[j].abs().max()))
    dx = outs[i].clone()
    flat = dx.view(-1, dx.shape[-1])
    row = int(flat.abs().amax(dim=1).argmax()) // 128 * 128
    flat[row:row + 128] = 0
    return tuple(dx if j == i else t for j, t in enumerate(outs))


# faults planted in the f32 tail's outputs (kernels phase, P = 512 and 200):
# the indexed forward's pool routing and the backward's dW and dx passes
TAIL_F32_PLANTED = {
    "pct_tail/idx": (("one argmax moved to the next point", _one_amax_moved),),
    "pct_tail_bwd": (("one dW column x1.1", _dw_column_scaled),
                     ("one 128-row tile of a dx zeroed", _dx_tile_zeroed))}


def _rows_zeroed(index: int, rows: int = 128):
    """A planted fault: the ``rows`` flat rows of output ``index`` (one row
    tile of an f32 C = 128 pass) holding its largest |value|, zeroed."""
    def fault(outs, args):
        outs = list(outs)
        t = outs[index].clone()
        flat = t.view(-1, t.shape[-1])
        row = int(flat.abs().amax(dim=1).argmax()) // rows * rows
        flat[row:row + rows] = 0
        outs[index] = t
        return tuple(outs)
    return f"output {index}: one {rows}-row tile zeroed", fault


# faults planted in the f32 C = 128 forms' outputs and the f32 embed_second
# pair's (kernels phase, P = 512 and 200), one a pass: a row tile of dx (the
# dx pass), dWqk x1.001 (the dq pass), dWt x1.001 (the dz pass; not the
# attention op's), the training forward's sums x1.001 (the slice sums) and a
# row tile of t_out (the trans pass)
NARROW_F32_PLANTED = {
    "pct_block_res_bwd": (_rows_zeroed(0), _scaled(1, 1.001), _scaled(4, 1.001)),
    "pct_block_bwd": (_rows_zeroed(0), _scaled(1, 1.001), _scaled(4, 1.001)),
    "pct_attn_bwd": (_rows_zeroed(0), _scaled(1, 1.001), _scaled(2, 1.001)),
    "pct_block_fwd": (_rows_zeroed(0), _scaled(2, 1.001)),
    # the f32 embed_second pair, with the faults of KERNEL_PLANTED: a 64-row
    # tile of h1 (the product) or dh0 (the dx0 pass) zeroed, Σh² or dwf
    # x1.001 (the epilogues' sums), dW1 x1.001 (the dW1 pass)
    "embed_second": KERNEL_PLANTED["embed_second"] + (_rows_zeroed(0, 64), _scaled(2, 1.001)),
    "embed_second_bwd": KERNEL_PLANTED["embed_second_bwd"] + (
        _rows_zeroed(0, 64), _scaled(1, 1.001), _scaled(3, 1.001))}


def _padding_kept(outs, args):
    """A planted fault of the PointNet forward at a width its kernel pads
    (EVA's C3 = 200): the padded channels left in the output (W3 and b3
    padded to the kernel's width, as the wrapper pads them, and nothing
    dropped)."""
    import torch.nn.functional as F

    from sgaligner_tpu_torch.ops.pointnet_fused import padded_width, pointnet_fwd

    x, w1, b1, w2, b2, w3, b3 = args
    extra = padded_width(w3.shape[1]) - w3.shape[1]
    return pointnet_fwd(x, w1, b1, w2, b2, F.pad(w3, (0, extra)), F.pad(b3, (0, extra)),
                        with_argmax=True)


def _last_channel_zeroed(outs, args):
    out, amax = outs
    out = out.clone()
    out[:, -1] = 0
    return out, amax


# faults planted in the padded PointNet forward's outputs (kernels phase,
# C3 = 200, bf16), each of which the comparison must catch
PADDED_PLANTED = (("the padded channels left in the output", _padding_kept),
                  ("the last real channel zeroed", _last_channel_zeroed))


def _crop_shifted(outs, args):
    """A planted fault of the PointNet backward at a width its kernel pads
    (EVA's C3 = 200): dW3 and db3 cropped at the wrong end of the padded
    width, so the padded columns come in and the first real ones drop."""
    import torch.nn.functional as F

    from sgaligner_tpu_torch.ops.pointnet_fused import BWD_MULTIPLE

    c3 = args[-1].shape[-1]
    extra = -(-c3 // BWD_MULTIPLE) * BWD_MULTIPLE - c3
    return (*outs[:4], *(F.pad(t, (0, extra))[:, extra:] for t in outs[4:]))


def _live_column_zeroed(outs, args):
    """dW3's and db3's column of the channel with the largest |db3| zeroed."""
    c = int(outs[5].abs().argmax())
    dw3, db3 = outs[4].clone(), outs[5].clone()
    dw3[:, c] = 0
    db3[:, c] = 0
    return (*outs[:4], dw3, db3)


# faults planted in the padded PointNet backward's outputs (kernels phase,
# C3 = 200 and 100, bf16): the crop's two ways to fail
PADDED_BWD_PLANTED = (("a padded column leaking into dW3 / db3", _crop_shifted),
                      ("a real channel's column zeroed", _live_column_zeroed))


def _live_channel_zeroed(outs, args):
    """The PointNet forward's channel with the largest max, zeroed in
    every object."""
    out, amax = outs
    out = out.clone()
    out[:, int(out.abs().amax(dim=0).argmax())] = 0
    return out, amax


def _shift_last(t, n: int = 8):
    """The last ``n`` columns of t moved one column on (the last to the
    first of them)."""
    t = t.clone()
    t[:, -n:] = t[:, -n:].roll(1, dims=1)
    return t


def _last_channels_shifted_fwd(outs, args):
    out, amax = outs
    return _shift_last(out), _shift_last(amax)


def _last_channels_shifted_bwd(outs, args):
    return (*outs[:4], _shift_last(outs[4]), _shift_last(outs[5]))


# faults planted in the f32 PointNet kernels' outputs at widths that are not
# a multiple of their tiles (kernels phase, C3 = 200 and 100: the kernels
# take any C3, so the ragged last channels are where they can go wrong)
F32_FWD_PLANTED = (("the channel with the largest max zeroed", _live_channel_zeroed),
                   ("the last 8 channels shifted by one", _last_channels_shifted_fwd))
F32_BWD_PLANTED = (("a real channel's column zeroed", _live_column_zeroed),
                   ("the last 8 columns of dW3 / db3 shifted by one", _last_channels_shifted_bwd))
# pct_block_eval's mixed flag pairs, which no model uses but the JAX op
# computes: SA's scale with OA's normalisation, and neither
MIXED_FLAGS = [("both", (True, True)), ("neither", (False, False))]
POINT_KERNELS = ("pointnet_fwd", "pointnet_bwd")
TRAIN_KERNELS = ("embed_first_bwd", "embed_second_bwd", "pct_block_fwd",
                 "pct_epi_sums", "pct_block_res_bwd", "pct_tail_bwd")
# the kernels of the ops pct_attention_fused and pct_block_fused (no model
# calls them; phase ops drives them)
OP_KERNELS = ("pct_attn_fwd", "pct_attn_bwd", "pct_block_bwd")
# the attention family: each runs with the SA and the OA flags. Wrapper and
# plain version in ops/pct_attention.py
ATTN_FNS = {"pct_block_eval": ("pct_block_eval", "block_eval_plain"),
            "pct_block_fwd": ("block_fwd", "block_fwd_plain"),
            "pct_block_res_bwd": ("block_res_bwd", "block_res_bwd_plain"),
            "pct_block_bwd": ("block_bwd", "block_bwd_plain"),
            "pct_attn_fwd": ("attn_fwd", "attn_fwd_plain"),
            "pct_attn_bwd": ("attn_bwd", "attn_bwd_plain")}
# the backward kernel whose dx at bf16 is held against the f32 plain version
# (BLOCK_DX_VS_PLAIN); pct_block_bwd and pct_attn_bwd (no residual, no relu
# routing) hold their dx to the bf16 plain version within their tolerance
BLOCK_BWD = ("pct_block_res_bwd",)


def tol(name: str, dt_name: str, flags=SA) -> float:
    """The tolerance of one kernel: its OA entry where there is one."""
    if flags == OA and (f"{name}/OA", dt_name) in TOL:
        return TOL[(f"{name}/OA", dt_name)]
    return TOL[(name, dt_name)]
# launches per pct train step: every kernel of the training path
PER_PCT_TRAIN_STEP = {"embed_first": 1, "embed_second": 1, "pct_tail": 1,
                      "embed_first_bwd": 1, "embed_second_bwd": 1,
                      "pct_block_fwd": 4, "pct_epi_sums": 4,
                      "pct_block_res_bwd": 4, "pct_tail_bwd": 1}
# positions of the per-object arguments of each op (the rest are weights)
PER_OBJECT_ARGS = {"embed_first": (0, 2), "embed_second": (0, 4),
                   "pct_block_eval": (0,), "pct_tail": (0, 1, 2, 3, 5)}
PER_REQUEST = {"embed_first": 1, "embed_second": 1, "pct_block_eval": 4,
               "pct_tail": 1}
PER_TRAIN_STEP = {"pointnet_fwd": 1, "pointnet_bwd": 1}
# The serving kernels' earlier design (shared-memory WMMA tiles, before
# wgmma), at the serving O = 13,440, bf16 (NVIDIA H100 80GB HBM3, 700.00 W):
# CUDA events, and pct_block_eval's passes under torch.profiler (pass_split)
WMMA_MS = {"pct_block_eval": 61.854, "pct_tail": 90.253, "embed_second": 9.624}
WMMA_SPLIT = {"project": 4.159, "lse": 4.838, "apply": 52.996}
# the kernel names of pct_block_eval's three bf16 passes
BLOCK_EVAL_PASSES = {"project": "project_wgmma_kernel", "lse": "lse_wgmma_kernel",
                     "apply": "apply_wgmma_kernel"}
# The bf16 backwards' earlier design (shared-memory WMMA passes) at O = 896
# (NVIDIA H100 80GB HBM3, 700.00 W; CUDA events, median of 5), and the
# kernel names of the wgmma design's passes (pass_split)
WMMA_BWD_MS = {"pct_block_res_bwd": 12.418, "pct_block_res_bwd/OA": 18.983,
               "pct_tail_bwd": 21.747, "pct_block_bwd": 11.488, "pct_block_bwd/OA": 18.854,
               "pct_attn_bwd": 7.199, "pct_attn_bwd/OA": 14.933, "embed_second_bwd": 3.088}
# The bf16 forwards redesigned in the wgmma design, in their earlier design
# (shared-memory WMMA passes) at O = 896 (NVIDIA H100 80GB HBM3, 700.00 W;
# CUDA events: the block as chip_smoke.py read it, embed_second the mean
# of two readings of scripts/chip_fwd_check.py on the earlier design), and
# the kernel names of their passes (pass_split)
WMMA_FWD_MS = {"pct_block_fwd": 3.913, "pct_block_fwd/OA": 4.544, "embed_second": 0.752}
BLOCK_FWD_PASSES = ("::project_wgmma_kernel", "::lse_wgmma_kernel", "::apply_wgmma_kernel",
                    "::reduce_slices_kernel")
EMBED_SECOND_PASSES = ("::embed_second_wgmma_kernel", "::reduce_slices_kernel")
EMBED_SECOND_BWD_PASSES = ("::embed_second_bwd_wgmma_kernel", "::reduce_slices_kernel")
# The PointNet forward's earlier design (shared-memory WMMA chunks) at the
# training O = 896 and the serving O = 13,440, bf16 (NVIDIA H100 80GB HBM3,
# 700.00 W; CUDA events, median of 5, chip_smoke.py)
POINTNET_WMMA_MS = {896: 1.100, 13440: 11.408}
BLOCK_BWD_PASSES = ("::project_wgmma_kernel", "::lse_wgmma_kernel", "::dz_wgmma_kernel",
                    "::dv_wgmma_kernel", "::dq_wgmma_kernel", "::dx_wgmma_kernel",
                    "::wgrad_wgmma_kernel", "::reduce_slices_kernel")
TAIL_BWD_PASSES = ("::transpose_w_kernel", "::tail_g_wgmma_kernel", "::tail_dx_wgmma_kernel",
                   "::wgrad_wgmma_kernel", "::reduce_slices_kernel")
# The first versions of the kernels redesigned after the wgmma ones, at
# O = 896, bf16 (NVIDIA H100 80GB HBM3, 700.00 W; CUDA events, median of 5,
# chip_smoke.py): the dense PointNet backward (shared-memory WMMA chunks),
# the epilogue sums and the first embedding's backward (one 2-byte load a
# thread and row) and the attention forward (shared-memory WMMA tiles),
# with the kernel names of the new designs' passes
FIRST_MS = {"pointnet_bwd": 3.296, "pct_epi_sums": 0.435, "embed_first_bwd": 0.220,
            "pct_attn_fwd": 2.480, "pct_attn_fwd/OA": 2.298}
POINTNET_BWD_PASSES = ("::pointnet_bwd_wgmma_kernel", "::pointnet_dw3_wgmma_kernel",
                       "::reduce_slices_kernel")
EPI_SUMS_PASSES = ("::epi_sums_stream_kernel", "::reduce_slices_kernel")
# The f32 PointNet kernels' first versions (the port's first design: shared-memory FMA
# chunks, C3 = 200 padded to 208) at the EVA retrain's O = 256 and C3 = 200
# (NVIDIA H100 80GB HBM3, 700.00 W; CUDA events, median of 5, chip_smoke.py),
# and the kernel names of the f32 backward's passes (pass_split)
F32_FIRST_MS = {"pointnet_bwd": 22.112, "pointnet_fwd": 2.270}
POINTNET_F32_BWD_PASSES = ("::transpose_w3_kernel", "::pointnet_bwd_f32_kernel",
                           "::pointnet_dw3_f32_kernel", "::pointnet_reduce_f32_kernel")
EMBED_FIRST_BWD_PASSES = ("::embed_first_bwd_stream_kernel", "::reduce_slices_kernel")
ATTN_FWD_PASSES = ("::project_wgmma_kernel", "::lse_wgmma_kernel", "::apply_wgmma_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median milliseconds of fn() by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------- inputs --------------------------------------

def wqk_scale(c: int) -> float:
    """The q/k weight's scale in the attention kernels' inputs: C^-1/2 at
    C = 128; (C·sqrt(da))^-1/2 at C = 256, where at C^-1/2 the energies'
    diagonal |q|² (about da = 64) leaves each column softmax one-hot to f32
    precision and dq (so dWqk) pure rounding noise on either side."""
    return c ** -0.5 if c == C else (c * (c // 4) ** 0.5) ** -0.5


def op_inputs(name: str, o: int, dtype, seed: int, p: int = P, c3: int = PN[-1],
              c: int = C) -> tuple:
    """Seeded inputs of one op at full width (p points per object; the
    PointNet's last width c3; the attention family's channels c, da = c / 4),
    on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    if name in POINT_KERNELS:
        from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_pool_plain

        x = rnd(o, 3, p)
        ws = []
        for cin, cout in zip((3, *PN[:-1]), (*PN[:-1], c3)):
            ws += [rnd(cin, cout, scale=cin ** -0.5), rnd(1, cout, scale=0.1)]
        if name == "pointnet_fwd":
            return (x, *ws)
        # the backward routes by the plain forward's argmax and max (both
        # sides get them)
        peak, amax = pointnet_pool_plain(x, *ws, with_argmax=True)
        return (x, rnd(o, c3), amax, peak, *ws)
    mask = (torch.rand(o, 1, generator=g) < 0.85).float()
    mask[0] = 1.0
    mask = mask.to("cuda", dtype)

    def f32(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", torch.float32)

    if name in TRAIN_KERNELS or name in OP_KERNELS:
        return train_op_inputs(name, o, p, rnd, f32, mask, c)
    if name == "embed_first":
        return rnd(o, 3, p), rnd(3, C), mask
    if name == "embed_second":
        return (rnd(o, p, C), rnd(1, C, scale=0.5), rnd(1, C, scale=0.1),
                rnd(C, C, scale=C ** -0.5), mask)
    if name == "pct_block_eval":
        wbn = (torch.rand(c, generator=g) + 0.5).cuda()
        return (rnd(o, p, c), rnd(c, c // 4, scale=wqk_scale(c)),
                rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1),
                rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1), wbn,
                (torch.randn(c, generator=g) * 0.1).cuda())
    return (*(rnd(o, p, C) for _ in range(4)), rnd(4 * C, K, scale=(4 * C) ** -0.5),
            mask)


def train_op_inputs(name: str, o: int, p: int, rnd, f32, mask, c: int = C) -> tuple:
    """Inputs of the training kernels: activations and weights as the
    forward ops take them, cotangents in the compute dtype (per point) or
    f32 (the BN sums' and the pool's), the tail's indices from the plain
    forward (both sides get them); the attention family's at c channels."""
    ds = (f32(1, c, scale=0.1), f32(1, c, scale=0.01))
    if name == "embed_first_bwd":
        return (rnd(o, 3, p), rnd(3, C), mask, rnd(o, p, C), *ds)
    if name == "embed_second_bwd":
        return (rnd(o, p, C), rnd(1, C, scale=0.5), rnd(1, C, scale=0.1),
                rnd(C, C, scale=C ** -0.5), mask, rnd(o, p, C), *ds)
    if name == "pct_epi_sums":
        return rnd(o, p, c), f32(c), f32(c, scale=0.1), rnd(o, p, c)
    attn = (rnd(o, p, c), rnd(c, c // 4, scale=wqk_scale(c)), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1))
    if name == "pct_attn_fwd":
        return attn
    if name == "pct_attn_bwd":
        return (*attn, rnd(o, p, c))
    if name in ("pct_block_fwd", "pct_block_res_bwd", "pct_block_bwd"):
        block = (*attn, rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1), mask)
        if name == "pct_block_fwd":
            return block
        if name == "pct_block_bwd":
            return (*block, rnd(o, p, c), *ds)
        return (*block, rnd(o, p, c), f32(c), f32(c, scale=0.1), *ds)
    from sgaligner_tpu_torch.ops.pct_tail import pct_tail_plain

    xs = tuple(rnd(o, p, C) for _ in range(4))
    w = rnd(4 * C, K, scale=(4 * C) ** -0.5)
    amax, amin = pct_tail_plain(*xs, w, mask, with_index=True)[4:]
    return (*xs, w, mask, f32(o, K), f32(o, K), f32(1, K, scale=0.01),
            f32(1, K, scale=0.001), amax, amin)


def untied(name: str, args: tuple, flags) -> tuple:
    """``args`` of the C = 256 kernels, and for pct_block_res_bwd with the
    cotangent dxn zeroed where the epilogue's relu input t_out·wbn + bbn (the
    flags' t_out at f64) lies within 1e-5 of 0, relative to its largest
    value: the kernel and the plain version sum t_out in other orders, and a
    tie may route either way (an H100 routed one at |z| = 7e-9 among O·P·C =
    3.4M the other way, which moved the f32 gradients by 2e-3). At O = 67,
    P = 200 that zeroes 473 of the 3.4M elements; every other goes through
    the comparison."""
    if name != "pct_block_res_bwd":
        return args
    from sgaligner_tpu_torch.ops.pct_attention import block_math

    x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, *rest = args
    t = block_math(*(a.double() for a in (x, wqk, wv, bv, wt, bt)), *flags)
    z = t * wbn.double() + bbn.double()
    tie = z.abs() < 1e-5 * z.abs().max()
    return (x, wqk, wv, bv, wt, bt, mask, dxn.masked_fill(tie, 0), wbn, bbn, *rest)


def op_fns(name: str, flags=SA):
    """(kernel wrapper, plain version) of one op. ``flags``: SA / OA for
    the attention family (ATTN_FNS), "idx" for pct_tail's training form."""
    from sgaligner_tpu_torch.ops import (pct_attention, pct_embed, pct_tail,
                                         pointnet_fused)

    if name in ATTN_FNS:
        scale, double_norm = flags
        kern, plain = (getattr(pct_attention, f) for f in ATTN_FNS[name])
        return (lambda *a: kern(*a, scale=scale, double_norm=double_norm),
                lambda *a: plain(*a, scale=scale, double_norm=double_norm))
    if name in TRAIN_KERNELS:
        module = pct_tail if name == "pct_tail_bwd" else (
            pct_embed if name.startswith("embed") else pct_attention)
        short = {"pct_epi_sums": "epi_sums"}.get(name, name)
        return getattr(module, short), getattr(module, short + "_plain")
    if name == "pct_tail" and flags == "idx":
        return (lambda *a: pct_tail.pct_tail(*a, with_index=True),
                lambda *a: pct_tail.pct_tail_plain(*a, with_index=True))
    if name == "pointnet_fwd":
        return (lambda *a: pointnet_fused.pointnet_fwd(*a, with_argmax=True),
                lambda *a: pointnet_fused.pointnet_fwd_plain(*a, with_argmax=True))
    if name == "pointnet_bwd":
        return pointnet_fused.pointnet_bwd, pointnet_fused.pointnet_bwd_plain
    if name == "embed_first":
        return pct_embed.embed_first, pct_embed.embed_first_plain
    if name == "embed_second":
        return pct_embed.embed_second, pct_embed.embed_second_plain
    return pct_tail.pct_tail, pct_tail.pct_tail_plain


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare(got, want) -> tuple[float, float]:
    """(max abs error over the per-object outputs, max normwise relative
    error over all outputs). The [1, ·] BN sums add up O·P values, so their
    absolute error scales with O·P; they are held by the relative check."""
    worst_abs, worst_rel = 0.0, 0.0
    if len(as_tuple(got)) != len(as_tuple(want)):
        raise AssertionError("kernel gives another number of outputs")
    for g, w in zip(as_tuple(got), as_tuple(want)):
        if g.shape != w.shape:
            raise AssertionError(f"kernel output has shape {tuple(g.shape)}, the "
                                 f"plain version's {tuple(w.shape)}")
        g, w = g.double(), w.double()
        if not bool(g.isfinite().all()):
            raise AssertionError("kernel output is not finite")
        err = float((g - w).abs().max())
        if g.shape[0] != 1:
            worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(w.abs().max()), 1e-30))
    return worst_abs, worst_rel


def argmax_error(args, amax) -> float:
    """The PointNet forward's argmax, held by value (near-ties are not ties:
    the kernel and the plain version sum in other orders): max over (object,
    channel) of |plain max - plain activation at the kernel's index|,
    relative to the largest max."""
    import torch

    from sgaligner_tpu_torch.ops.pointnet_fused import stack_plain

    h3 = torch.relu(stack_plain(*args)[0])                  # [O, P, C3] f32
    at = torch.gather(h3, 1, amax.long()[:, None, :])[:, 0]
    peak = h3.amax(dim=1)
    return float((peak - at).abs().max() / peak.abs().max().clamp_min(1e-30))


def tail_index_error(args, amax, amin) -> float:
    """The tail's argmax / argmin, held by value as the PointNet argmax is:
    max over (object, channel) of |plain max - plain z at the kernel's
    index| (and the same for the min), relative to the largest |z|."""
    import torch

    from sgaligner_tpu_torch.ops.pct_tail import _z

    z = _z(list(args[:4]), args[4]).float()                   # [O, P, K]
    err = 0.0
    for idx, peak in ((amax, z.amax(dim=1)), (amin, z.amin(dim=1))):
        at = torch.gather(z, 1, idx.long()[:, None, :])[:, 0]
        err = max(err, float((peak - at).abs().max()))
    return err / max(float(z.abs().max()), 1e-30)


def check_op(name: str, args: tuple, dt_name: str, flags=SA,
             what: str = "") -> tuple[float, float]:
    """One kernel call against its plain version on the same inputs;
    raises past the tolerance. Returns (max abs, max normwise rel)."""
    import torch

    kern, plain = op_fns(name, flags)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    return judge(name, dt_name, flags, args, got, want, plain, what)


def judge(name: str, dt_name: str, flags, args: tuple, got, want, plain,
          what: str = "") -> tuple[float, float]:
    """A kernel's outputs ``got`` against its plain version's ``want`` on
    ``args``; raises past the tolerance. Returns (max abs, max normwise
    rel)."""
    limit = tol(name, dt_name, flags)
    if name in BLOCK_BWD and dt_name == "bf16":
        return check_block_bwd_bf16(args, got, want, plain, limit, what or name)
    if name == "pointnet_fwd":
        (got, amax), (want, _) = got, want
        if amax.shape != want.shape:
            raise AssertionError(f"{what or name}: argmax has shape {tuple(amax.shape)}, "
                                 f"the output {tuple(want.shape)}")
        arg_err = argmax_error(args, amax)
        if not arg_err <= limit:
            raise AssertionError(f"{what or name}: argmax points off the max "
                                 f"({arg_err:.3e} > {limit:g})")
    if name == "pct_tail" and flags == "idx":
        arg_err = tail_index_error(args, got[4], got[5])
        got, want = got[:4], want[:4]
        if not arg_err <= limit:
            raise AssertionError(f"{what or name}: argmax / argmin point off the "
                                 f"max / min ({arg_err:.3e} > {limit:g})")
    err_abs, err_rel = compare(got, want)
    if not err_rel <= limit:
        raise AssertionError(f"{what or name}: kernel disagrees with the plain "
                             f"version ({err_rel:.3e} > {limit:g})")
    return err_abs, err_rel


def check_block_bwd_bf16(args, got, want, plain, tol: float, what: str
                         ) -> tuple[float, float]:
    """pct_block_res_bwd at bf16: the weight gradients against the plain
    version within ``tol``; dx against the plain version at f32 on the same
    values, no further from it than BLOCK_DX_VS_PLAIN times the bf16 plain
    version's dx. Returns (max abs, max normwise rel of the weight
    gradients)."""
    rel = max(compare(g, w)[1] for g, w in zip(got[1:], want[1:]))
    if not rel <= tol:
        raise AssertionError(f"{what}: kernel's weight gradients disagree with the "
                             f"plain version ({rel:.3e} > {tol:g})")
    ref = plain(*(a.float() for a in args))[0]
    kern_d, plain_d = compare(got[0], ref)[1], compare(want[0], ref)[1]
    log(f"[kernels] {what}: dx normwise from the plain version at f32: kernel "
        f"{kern_d:.3e}, plain at bf16 {plain_d:.3e} (ratio bound {BLOCK_DX_VS_PLAIN}); "
        f"kernel against plain at bf16: dx {compare(got[0], want[0])[1]:.3e}, weight "
        f"gradients " + ", ".join(f"{compare(g, w)[1]:.2e}" for g, w in zip(got[1:], want[1:])))
    if not kern_d <= BLOCK_DX_VS_PLAIN * plain_d:
        raise AssertionError(f"{what}: kernel's dx is {kern_d:.3e} from the f32 plain "
                             f"version, more than {BLOCK_DX_VS_PLAIN} x the bf16 plain "
                             f"version's {plain_d:.3e}")
    return compare(got, want)[0], rel


# ------------------------------- phases --------------------------------------

def phase_device(state: dict) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["kind"] = torch.cuda.get_device_name(0)
    state["card"] = card_line()
    log(f"[device] {state['kind']} | nvidia-smi: {state['card']} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")


def phase_build(state: dict) -> None:
    from sgaligner_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {time.perf_counter() - t0:.1f} s "
        f"(cached={_build.build_info['cached']}) {_build.build_info['path']}")
    build_log = Path(_build.build_info["path"]).parent / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            if "Compiling entry" in line or "Used" in line or spills:
                log(f"[build] {line.strip()}")


def phase_kernels(state: dict) -> None:
    import torch

    # P=512 as on the main path, then a ragged P (not a multiple of the
    # kernels' 64-row tiles)
    cases = [(dt_name, dtype, p) for p in (P, RAGGED_P)
             for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    for dt_name, dtype, p in cases:
        for name in KERNELS:
            variants = ([("SA", SA), ("OA", OA)] if name in ATTN_FNS else
                        [("", None), ("idx", "idx")] if name == "pct_tail" else [("", None)])
            if name == "pct_block_eval":
                variants += MIXED_FLAGS
            for tag, flags in variants:
                kern, plain = op_fns(name, flags or SA)
                args = op_inputs(name, SMALL_O, dtype, seed=1, p=p)
                label = f"{name}{'/' + tag if tag else ''}/{dt_name}"
                err_abs, err_rel = check_op(name, args, dt_name, flags or SA, label)
                if dt_name == "bf16" and p == P:
                    check_planted(name, args, flags or SA, label)
                planted = (TAIL_F32_PLANTED.get(name + ("/idx" if flags == "idx" else ""))
                           or NARROW_F32_PLANTED.get(name))
                if dt_name == "f32" and planted:
                    check_planted(name, args, flags or SA, label, "f32", planted)
                if name in TRAIN_KERNELS or name in OP_KERNELS or name in SAME_BITS:
                    first, second = as_tuple(kern(*args)), as_tuple(kern(*args))
                    if not all(torch.equal(a, b) for a, b in zip(first, second)):
                        raise AssertionError(f"{label}: two runs on the same inputs "
                                             "differ (the kernel must be deterministic)")
                ms = cuda_ms(lambda: kern(*args))
                plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
                log(f"[kernels] {label:24s} O={SMALL_O} P={p} max_abs={err_abs:.3e} "
                    f"max_rel={err_rel:.3e} (tol {tol(name, dt_name, flags or SA):g}) "
                    f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    # the PointNet forward at EVA's C3 = 200: bf16's wrapper pads to the
    # kernel's width (256) and crops; the f32 kernel takes it as it is
    kern, plain = op_fns("pointnet_fwd")
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = op_inputs("pointnet_fwd", SMALL_O, dtype, seed=3, c3=EVA_C3)
        label = f"pointnet_fwd/C3={EVA_C3}/{dt_name}"
        err_abs, err_rel = check_op("pointnet_fwd", args, dt_name, what=label)
        check_planted("pointnet_fwd", args, SA, label, dt_name,
                      PADDED_PLANTED if dt_name == "bf16" else F32_FWD_PLANTED)
        first, second = kern(*args), kern(*args)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{label}: two runs on the same inputs differ")
        log(f"[kernels] {label:24s} O={SMALL_O} P={P} max_abs={err_abs:.3e} "
            f"max_rel={err_rel:.3e} (tol {tol('pointnet_fwd', dt_name):g}) output "
            f"{tuple(first[0].shape)}")
    # the PointNet backward at C3 = 200 (EVA) and 100, at O = 67 and at the
    # EVA retrain's O: bf16's wrapper pads to the kernel's multiple of 16 and
    # crops (padded_bwd); the f32 kernels take any C3
    kern, plain = op_fns("pointnet_bwd")
    for c3 in (EVA_C3, EVA_C3 // 2):
        for o in (SMALL_O, EVA_TRAIN_O):
            for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                args = op_inputs("pointnet_bwd", o, dtype, seed=4, c3=c3)
                label = f"pointnet_bwd/C3={c3}/{dt_name}"
                err_abs, err_rel = check_op("pointnet_bwd", args, dt_name, what=label)
                check_planted("pointnet_bwd", args, SA, f"{label} O={o}", dt_name,
                              PADDED_BWD_PLANTED if dt_name == "bf16" else F32_BWD_PLANTED)
                first, second = kern(*args), kern(*args)
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    raise AssertionError(f"{label}: two runs on the same inputs differ")
                log(f"[kernels] {label:24s} O={o} P={P} max_abs={err_abs:.3e} "
                    f"max_rel={err_rel:.3e} (tol {tol('pointnet_bwd', dt_name):g}) dW3 "
                    f"{tuple(first[4].shape)}")
    check_wide_kernels()


def check_wide_kernels() -> None:
    """The kernels at C = 256 (WIDE) against their plain versions, at
    O = 67, P = 256 and the ragged P, f32 and bf16, SA and OA: one launch of
    the C = 256 kernel a call, the same bits twice, and the planted faults
    of KERNEL_PLANTED (at f32 also WIDE_F32_PLANTED) in the backwards'
    outputs caught."""
    import torch

    from sgaligner_tpu_torch.ops import _build

    for p in (WIDE_P, RAGGED_P):
        for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for wide, name in WIDE.items():
                variants = [("", SA)] if name == "pct_epi_sums" else [("SA", SA), ("OA", OA)]
                for tag, flags in variants:
                    kern, plain = op_fns(name, flags)
                    args = untied(name, op_inputs(name, SMALL_O, dtype, seed=11, p=p, c=WIDE_C),
                                  flags)
                    label = f"{wide}{'/' + tag if tag else ''}/{dt_name}"
                    before = _build.LAUNCHES[wide]
                    err_abs, err_rel = check_op(name, args, dt_name, flags, label)
                    if _build.LAUNCHES[wide] != before + 1:
                        raise AssertionError(f"{label}: {_build.LAUNCHES[wide] - before} "
                                             "launches of the C = 256 kernel, expected 1")
                    if name in WIDE_F32_PLANTED and p == WIDE_P:
                        check_planted(name, args, flags, label, dt_name,
                                      KERNEL_PLANTED[name]
                                      + (WIDE_F32_PLANTED[name] if dt_name == "f32" else ()))
                    first, second = as_tuple(kern(*args)), as_tuple(kern(*args))
                    if not all(torch.equal(a, b) for a, b in zip(first, second)):
                        raise AssertionError(f"{label}: two runs on the same inputs differ "
                                             "(the kernel must be deterministic)")
                    ms = cuda_ms(lambda: kern(*args), warmup=1, reps=3)
                    log(f"[kernels] {label:30s} O={SMALL_O} P={p} C={WIDE_C} "
                        f"max_abs={err_abs:.3e} max_rel={err_rel:.3e} "
                        f"(tol {tol(name, dt_name, flags):g}) kernel {ms:.3f} ms")
                    del args, first, second


def check_planted(name: str, args: tuple, flags, label: str, dt_name: str = "bf16",
                  faults: tuple | None = None) -> None:
    """Faults planted in a kernel's outputs (``faults``, by default the
    wgmma kernels' KERNEL_PLANTED) must each fail the comparison with the
    plain version."""
    import torch

    kern, plain = op_fns(name, flags)
    got, want = as_tuple(kern(*args)), as_tuple(plain(*args))
    torch.cuda.synchronize()
    for what, fault in (KERNEL_PLANTED.get(name, ()) if faults is None else faults):
        try:
            judge(name, dt_name, flags, args, fault(got, args), want, plain, f"{label} planted")
        except AssertionError:
            log(f"[kernels] {label}: planted fault ({what}) caught")
            continue
        raise AssertionError(f"{label}: planted fault ({what}) went unseen")


def _cfg(dtype: str, max_objects: int, modules=MODULES):
    from sgaligner_tpu_torch.core.config import make_cfg

    cfg = make_cfg(modules=list(modules))
    cfg.tpu.max_objects = max_objects
    cfg.tpu.points_per_object = P
    cfg.tpu.compute_dtype = dtype
    return cfg


def _valid(batch, emb):
    import torch

    mask = torch.as_tensor(batch["obj_mask"]).reshape(-1).to(emb.device)
    return emb[mask]


def phase_parity(state: dict) -> None:
    import numpy as np
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import make_serving_step

    from sgaligner_tpu_torch.ops import _build

    cfg = _cfg("float32", 32)
    host = pool_compact(make_synthetic_batch(
        BatchSpec(8, 32, P), seed=3, bow_noise=1.0, resample=True), 128)
    outs, embs = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, torch.Generator().manual_seed(11))
        batch = to_device(host, dev)
        if dev == "cuda":
            # the f32 forms' launches are counted from here to the end of
            # oa_parity; the f32 serving request's alone are read just after
            # it (time_f32_forms reads both)
            _build.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            embs[dev] = {k: v.double().cpu() for k, v in model(batch).items()}
            outs[dev] = make_serving_step(model, MODULES)(batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            state["launches_serve_f32"] = served = dict(_build.LAUNCHES)
            if not served["pct_tail"] or served["pct_tail_bwd"]:
                raise AssertionError(f"parity: the f32 serving request launched pct_tail "
                                     f"{served['pct_tail']} and pct_tail_bwd "
                                     f"{served['pct_tail_bwd']} times")
        log(f"[parity] {dev}: forward + serving step {time.perf_counter() - t0:.1f} s")
    o = host["obj_points_pooled"].shape[0]
    for m in (*MODULES, "joint"):
        ref = _valid(host, embs["cpu"][m])
        got = _valid(host, embs["cuda"][m])
        if not bool(got.isfinite().all()):
            raise AssertionError(f"parity: {m} embeddings not finite on the card")
        drift = float((got - ref).abs().max() / ref.abs().max())
        log(f"[parity] O={o} {m:6s} relative drift {drift:.3e} (bound {PARITY_DRIFT})")
        if not drift <= PARITY_DRIFT:
            raise AssertionError(f"parity: {m} drift {drift:.3e} > {PARITY_DRIFT}")
    cpu, gpu = outs["cpu"], outs["cuda"]
    for k in ("rr_count", "hits@1"):
        a = cpu[k][-1] if isinstance(cpu[k], tuple) else cpu[k]
        b = gpu[k][-1] if isinstance(gpu[k], tuple) else gpu[k]
        if int(a) != int(b):
            raise AssertionError(f"parity: {k} totals differ: {int(a)} vs {int(b)}")
    count = int(cpu["rr_count"])
    rr_c, rr_g = float(cpu["rr_sum"]), float(gpu["rr_sum"])
    hit_c, hit_g = int(cpu["hits@1"][0]), int(gpu["hits@1"][0])
    al_c = cpu["alignment_score"].cpu().numpy()
    al_g = gpu["alignment_score"].cpu().numpy()
    log(f"[parity] anchors {count}: MRR cpu {rr_c / count:.6f} card {rr_g / count:.6f}; "
        f"hits@1 {hit_c} / {hit_g}; alignment_score mean {al_c.mean():.6f} / {al_g.mean():.6f}")
    # a rank may flip where two candidates' similarities are within the drift
    if abs(rr_c - rr_g) > 0.02 * count or abs(hit_c - hit_g) > max(1, 0.02 * count) \
            or float(np.abs(al_c - al_g).max()) > 0.1:
        raise AssertionError("parity: serving metrics differ between CPU and card")


def phase_serve(state: dict) -> None:
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import make_serving_step
    from sgaligner_tpu_torch.ops import _build

    b = 512
    cfg = _cfg("bfloat16", 32)
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    step = make_serving_step(model, MODULES)
    t0 = time.perf_counter()
    raws = [make_synthetic_batch(BatchSpec(b, 32, P), seed=100 + i) for i in range(4)]
    hosts = [pool_compact(r, 128) for r in raws]
    state["serve_raw"] = raws                 # served again by the artifacts
    batches = [to_device(h, "cuda") for h in hosts]
    torch.cuda.synchronize()
    os_ = [h["obj_points_pooled"].shape[0] for h in hosts]
    log(f"[serve] set-up {time.perf_counter() - t0:.1f} s; pooled objects O per request {os_}")
    state["serve_o"] = max(os_)
    state["serve_batches"] = batches          # served again by serve_point

    with torch.inference_mode():                     # warm-up (not counted)
        embs = model(batches[0])
        for k, v in embs.items():
            if not bool(v.isfinite().all()):
                raise AssertionError(f"serve: {k} embeddings not finite")
        step(batches[0])
    torch.cuda.synchronize()

    _build.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(_build.LAUNCHES)
    state["launches"] = launches
    for name, per in PER_REQUEST.items():
        if launches[name] != per * len(batches):
            raise AssertionError(f"serve: {name} launched {launches[name]} times, "
                                 f"expected {per} x {len(batches)}")
    for i, out in enumerate(outs):
        for k, v in out.items():
            vals = v if isinstance(v, tuple) else (v,)
            for t in vals:
                if not bool(torch.as_tensor(t).double().isfinite().all()):
                    raise AssertionError(f"serve: request {i} {k} not finite")
        log(f"[serve] request {i}: O={os_[i]} {times[i] * 1e3:.1f} ms "
            f"({b / times[i]:.1f} pairs/s) MRR {float(out['rr_sum']) / int(out['rr_count']):.4f} "
            f"| {state['card']}")
    med = statistics.median(times)
    state["serve_ms"] = med * 1e3
    log(f"[serve] median {med * 1e3:.1f} ms per request, {b / med:.1f} pairs/s "
        f"(B={b}, bf16) | launches {launches} | {state['card']}")


def _train_three(cfg, host, dev: str, modules=POINT_MODULES, mesh=None) -> dict:
    """Three train steps from the seeded weights (pct: head dropout off, so
    the CPU and the card draw no masks) with ``cfg``'s objective
    (``build_objective``: EVA's is NCA): the losses, the first step's
    gradients, the starting and final parameters and buffers. A float64
    ``cfg`` keeps the parameters, Adam and the loss at float64 too. With a
    ``mesh`` (data parallel) this rank steps on its block of ``host``, and
    the gradients read are the whole batch's."""
    import torch

    from sgaligner_tpu_torch.data.batch import to_device
    from sgaligner_tpu_torch.engine.factory import build_model, build_objective
    from sgaligner_tpu_torch.engine.train_step import create_train_state, make_train_step
    from sgaligner_tpu_torch.parallel.mesh import shard_batch

    model = build_model(cfg, dev, torch.Generator().manual_seed(11))
    objective = build_objective(cfg)
    if cfg.tpu.compute_dtype == "float64":
        model = model.double()
        objective = objective.double()
    if "pct" in modules:
        model.object_encoder.dropout = 0.0
    start = {k: v.detach().double().cpu().clone() for k, v in model.state_dict().items()}
    train = create_train_state(model, cfg, objective)
    step = make_train_step(modules, mesh)
    batch = to_device(shard_batch(host, mesh), dev)
    t0 = time.perf_counter()
    losses = [step(train, batch)]
    # the first step's gradients (the next step clears them)
    grads = {k: v.grad.double().cpu() for k, v in
             [*model.named_parameters(),
              *(("loss." + n, q) for n, q in train.objective.named_parameters())]}
    losses += [step(train, batch) for _ in range(2)]
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    if train.updates != 3:
        raise AssertionError(f"train_parity: {dev} applied {train.updates} of 3 updates")
    return {"losses": [{k: float(v) for k, v in o.items()} for o in losses],
            "grads": grads, "start": start, "seconds": time.perf_counter() - t0,
            "params": {k: v.detach().double().cpu() for k, v in model.state_dict().items()}}


# A leaf whose first-step gradient on the CPU is under QUIET_GRAD times the
# median leaf's is zero up to rounding: in the pct configuration the biases
# right before a batch-statistics BatchNorm (its batch mean removes them),
# 3e-10 to 1.5e-7 against 1.5e-2 for the smallest other leaf and a median of
# about 0.4. Adam moves such a leaf by noise, so it is left out of the
# gradient and parameter readings
QUIET_GRAD = 1e-4


def _norm(tensors) -> float:
    return sum(float(t.norm() ** 2) for t in tensors) ** 0.5


def quiet_leaves(grads: dict) -> set:
    norms = {k: float(g.norm()) for k, g in grads.items()}
    floor = QUIET_GRAD * statistics.median(norms.values())
    return {k for k, n in norms.items() if n < floor}


def _train_readings(ref: dict, got: dict, bounds: dict) -> dict:
    """The card run against the CPU run: worst gradient leaf, worst loss,
    parameter drift and (pct) the running statistics' drift; and which
    checks fail. Quiet leaves (``quiet_leaves`` of the CPU's gradients) are
    left out of the gradient and parameter readings."""
    for i, losses in enumerate(got["losses"]):
        if not all(abs(v) < float("inf") and v == v for v in losses.values()):
            raise AssertionError(f"train_parity: step {i} loss not finite on the card: {losses}")
    quiet = quiet_leaves(ref["grads"])
    loss = max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-30)
               for a, b in zip(ref["losses"], got["losses"]) for k in a)
    grad = {k: float((got["grads"][k] - g).norm() / g.norm().clamp_min(1e-30))
            for k, g in ref["grads"].items() if k not in quiet}
    leaf = max(grad, key=grad.get)
    start, p_ref, p_got = ref["start"], ref["params"], got["params"]
    keys = [k for k in start if "running_" not in k and k not in quiet]
    moved = _norm(p_ref[k] - start[k] for k in keys)
    apart = {k: float((p_got[k] - p_ref[k]).norm()) for k in keys}
    r = {"leaf": leaf, "grad": grad[leaf], "loss": loss,
         "param": sum(v * v for v in apart.values()) ** 0.5 / moved,
         "param_leaf": max(apart, key=apart.get), "quiet": sorted(quiet)}
    stats = [k for k in start if "running_" in k]
    if stats:
        r["stats"] = (_norm(p_got[k] - p_ref[k] for k in stats)
                      / _norm(p_ref[k] for k in stats))
    r["failed"] = [name for name, bound in bounds.items() if not r[name] <= bound]
    return r


def phase_train_parity(state: dict) -> None:
    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.ops import pointnet_fused

    bounds = {"grad": TRAIN_GRAD_DRIFT, "loss": TRAIN_LOSS_DRIFT, "param": TRAIN_PARAM_DRIFT}
    cfg = _cfg("float32", 32, POINT_MODULES)
    host = pool_compact(make_synthetic_batch(
        BatchSpec(8, 32, P), seed=3, bow_noise=1.0, resample=True), 128)
    o = host["obj_points_pooled"].shape[0]
    runs = {dev: _train_three(cfg, host, dev) for dev in ("cpu", "cuda")}
    for dev, run in runs.items():
        log(f"[train_parity] {dev}: 3 train steps {run['seconds']:.1f} s; loss "
            + ", ".join(f"{v['loss']:.6f}" for v in run["losses"]))
    r = _train_readings(runs["cpu"], runs["cuda"], bounds)
    log(f"[train_parity] O={o} worst gradient leaf {r['leaf']} {r['grad']:.3e} (bound "
        f"{TRAIN_GRAD_DRIFT:g}); losses: max relative difference {r['loss']:.3e} (bound "
        f"{TRAIN_LOSS_DRIFT:g}); parameters: card-CPU distance / distance moved "
        f"{r['param']:.3e} (bound {TRAIN_PARAM_DRIFT:g}); quiet leaves left out: {r['quiet']}")
    if r["failed"]:
        raise AssertionError(f"train_parity: the card's training differs from the "
                             f"CPU's ({', '.join(r['failed'])}): {r}")

    kernel = pointnet_fused.pointnet_bwd
    for label, index, factor in PLANTED:
        def planted(*args):
            grads = list(kernel(*args))
            grads[index] = grads[index] * factor
            return tuple(grads)

        pointnet_fused.pointnet_bwd = planted
        try:
            f = _train_readings(runs["cpu"], _train_three(cfg, host, "cuda"), bounds)
        finally:
            pointnet_fused.pointnet_bwd = kernel
        log(f"[train_parity] planted fault {label}: gradient {f['leaf']} {f['grad']:.3e}, "
            f"loss {f['loss']:.3e}, parameters {f['param']:.3e}; caught by {f['failed']}")
        if not f["failed"]:
            raise AssertionError(f"train_parity: the planted fault {label} went unseen")


def _planted(kernel, index, factor):
    """kernel with one output (or several, or its only one) scaled."""
    def fn(*args):
        out = kernel(*args)
        if index is None:
            return out * factor
        out = list(out)
        for i in (index if isinstance(index, tuple) else (index,)):
            out[i] = out[i] * factor
        return tuple(out)

    return fn


@contextlib.contextmanager
def tail_indices(record: list, replay: list | None = None, rows: slice = slice(None)):
    """Patch the tail op the training forward calls (``PctTail``): append
    the argmax / argmin that each indexed call computes to ``record`` (on
    the host) and, with ``replay``, route the call to the recorded indices
    instead, in call order: where a recorded index differs from the call's
    own, pmax / pmin are taken at it from the plain z (elsewhere they stay
    the call's); ``rows``: this rank's objects of each recorded call (data
    parallel)."""
    import torch

    from sgaligner_tpu_torch.ops import pct_tail as mod

    op, queue = mod.pct_tail, iter(replay or ())

    def fn(x1, x2, x3, x4, w, mask, with_index=False):
        out = op(x1, x2, x3, x4, w, mask, with_index)
        if not with_index:
            return out
        record.append((out[4].cpu(), out[5].cpu()))
        if replay is not None:
            amax, amin = (t[rows].to(x1.device) for t in next(queue))
            pmax, pmin = out[0], out[1]
            if not (torch.equal(amax, out[4]) and torch.equal(amin, out[5])):
                z = mod._z([x1, x2, x3, x4], w).to(out[0].dtype)

                def at(i, own, p):
                    return torch.where(i == own, p, torch.gather(z, 1, i.long()[:, None, :])[:, 0])

                pmax, pmin = at(amax, out[4], pmax), at(amin, out[5], pmin)
            out = (pmax, pmin, out[2], out[3], amax, amin)
        return out

    mod.pct_tail = fn
    try:
        yield
    finally:
        mod.pct_tail = op


def phase_train_pct_parity(state: dict) -> None:
    import importlib

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch

    host = pool_compact(make_synthetic_batch(
        BatchSpec(4, 32, P), seed=3, bow_noise=1.0, resample=True), 128)
    o = host["obj_points_pooled"].shape[0]
    idx = {"cuda": [], "cpu": [], "cpu64": []}
    runs = {}
    for name, dev, dtype in (("cuda", "cuda", "float32"), ("cpu", "cpu", "float32"),
                             ("cpu64", "cpu", "float64")):
        # the CPU runs route the tail to the card's indices
        with tail_indices(idx[name], None if dev == "cuda" else idx["cuda"]):
            runs[name] = _train_three(_cfg(dtype, 32, MODULES), host, dev, MODULES)
        log(f"[train_pct_parity] {name}: 3 train steps {runs[name]['seconds']:.1f} s; loss "
            + ", ".join(f"{v['loss']:.6f}" for v in runs[name]["losses"]))
    apart = [int((a != b).sum()) + int((c != d).sum())
             for (a, c), (b, d) in zip(idx["cpu"], idx["cuda"])]
    total = 2 * idx["cuda"][0][0].numel()
    # the CPU at float32 against float64 sets the bounds of the card's run
    ref = _train_readings(runs["cpu64"], runs["cpu"], {})
    bounds = {k: PCT_VS_CPU * ref[k] for k in ("grad", "loss", "param", "stats")}
    r = _train_readings(runs["cpu64"], runs["cuda"], bounds)
    log(f"[train_pct_parity] O={o} tail argmax / argmin the CPU at f32 picks apart from the "
        f"card, per step: {apart} of {total} (bound {PCT_INDEX_APART:g} of them at step 1); "
        f"quiet leaves left out: {r['quiet']}")
    direct = _train_readings(runs["cpu"], runs["cuda"], {})
    for who, x in (("CPU at f32 against the CPU at f64", ref),
                   ("card at f32 against the CPU at f64", r),
                   ("card at f32 against the CPU at f32", direct)):
        log(f"[train_pct_parity] O={o} {who}: worst gradient leaf "
            f"{x['leaf']} {x['grad']:.3e}; losses {x['loss']:.3e}; parameters "
            f"{x['param']:.3e} (most in {x['param_leaf']}); running statistics {x['stats']:.3e}")
    failed = list(r["failed"])
    if not apart[0] <= PCT_INDEX_APART * total:
        failed.append("index")
    if failed:
        raise AssertionError(f"train_pct_parity: the card's training is further from the "
                             f"f64 run than {PCT_VS_CPU} x the CPU's ({', '.join(failed)}): {r}")
    unseen = []
    for label, module, fn_name, index, factor in PCT_PLANTED:
        mod = importlib.import_module(f"sgaligner_tpu_torch.ops.{module}")
        kernel = getattr(mod, fn_name)
        setattr(mod, fn_name, _planted(kernel, index, factor))
        try:
            f = _train_readings(runs["cpu64"], _train_three(_cfg("float32", 32, MODULES),
                                                            host, "cuda", MODULES), bounds)
        finally:
            setattr(mod, fn_name, kernel)
        log(f"[train_pct_parity] planted fault {label}: gradient {f['leaf']} {f['grad']:.3e}, "
            f"loss {f['loss']:.3e}, parameters {f['param']:.3e}, statistics "
            f"{f['stats']:.3e}; caught by {f['failed']}")
        if not f["failed"]:
            unseen.append(label)
    if unseen:
        raise AssertionError(f"train_pct_parity: the planted faults {unseen} went unseen")


def _spct_three(dtype, dev: str, pts, mask) -> dict:
    """Three Adam steps (lr 1e-3) of SPCT in train mode from the seeded
    weights (``init_weights``, seed 11) on the loss Σ_k <out_k, ct_k> over
    its three outputs, with seeded cotangents: the losses, the first step's
    outputs and gradients, the starting and final parameters and running
    statistics (``_train_readings``' form)."""
    import torch

    from sgaligner_tpu_torch.engine.factory import init_weights
    from sgaligner_tpu_torch.models.pct import SPCT

    net = SPCT(dtype)
    init_weights(net, torch.Generator().manual_seed(11))
    net = net.to(dev, torch.float64) if dtype == torch.float64 else net.to(dev)
    net.train()
    start = {k: v.detach().double().cpu().clone() for k, v in net.state_dict().items()}
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    o, p = pts.shape[:2]
    g = torch.Generator().manual_seed(5)
    cts = [torch.randn(*shape, generator=g).to(dev, dtype)
           for shape in ((o, p, 1024), (o, 1024), (o, 1024))]
    pts, mask = pts.to(dev), mask.to(dev)
    losses, t0 = [], time.perf_counter()
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        outs = net(pts, mask)
        loss = sum((a * c).sum() for a, c in zip(outs, cts))
        loss.backward()
        if step == 0:
            outputs = [t.detach().double().cpu() for t in outs]
            grads = {k: q.grad.double().cpu() for k, q in net.named_parameters()}
        opt.step()
        losses.append({"loss": float(loss.detach())})
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "outputs": outputs, "start": start,
            "seconds": time.perf_counter() - t0,
            "params": {k: v.detach().double().cpu() for k, v in net.state_dict().items()}}


def _spct_readings(ref: dict, got: dict, bounds: dict) -> dict:
    """_train_readings plus "outputs": the first step's worst output,
    ||got - ref|| / ||ref||."""
    r = _train_readings(ref, got, {k: v for k, v in bounds.items() if k != "outputs"})
    r["outputs"] = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                       for a, b in zip(got["outputs"], ref["outputs"]))
    if "outputs" in bounds and not r["outputs"] <= bounds["outputs"]:
        r["failed"].append("outputs")
    return r


def _op_grads(op: str, flags, dev: str, dtype, args) -> tuple:
    """Gradients of pct_attention_fused / pct_block_fused (autograd) for
    seeded cotangents, on ``dev`` in ``dtype``: (x, then the weights),
    double on the CPU. ``args``: op_inputs of its backward kernel."""
    import torch

    from sgaligner_tpu_torch.ops import pct_attention

    n = 4 if op == "attention" else 6
    leaves = [a.detach().to(dev, dtype).requires_grad_(True) for a in args[:n]]
    extra = [] if op == "attention" else [args[n].to(dev, dtype)]
    fn = pct_attention.pct_attention_fused if op == "attention" else pct_attention.pct_block_fused
    outs = as_tuple(fn(*leaves, *extra, *flags))
    g = torch.Generator().manual_seed(6)
    rows = args[0].shape[0] * args[0].shape[1]
    # the [1, C] sums' cotangents at 1/(O·P), as moments reach a loss
    cts = [(torch.randn(t.shape, generator=g) / (rows if t.shape[0] == 1 else 1)).to(dev, t.dtype)
           for t in outs]
    grads = torch.autograd.grad(outs, leaves, cts)
    return tuple(t.double().cpu() for t in grads)


# the ops' widths in oa_parity: (C, P), the models' 128 at P = 512 and
# FullPCT's 256 at its P = 256
OP_WIDTHS = ((C, P), (WIDE_C, WIDE_P))


def _op_readings(ops: dict, kernels: dict | None = None) -> dict:
    """Each op's gradients on the card at f32 against the CPU at f64, with
    its bound (the backward kernel's f32 tolerance plus PCT_VS_CPU times the
    CPU's own f32 distance). ``kernels`` replaces the card's run."""
    out = {}
    for key, run in ops.items():
        card = (kernels or {}).get(key, run["cuda"])
        cpu_rel = compare(run["cpu"], run["cpu64"])[1]
        bwd = "pct_attn_bwd" if key[0] == "attention" else "pct_block_bwd"
        out[key] = (compare(card, run["cpu64"])[1], TOL[(bwd, "f32")] + PCT_VS_CPU * cpu_rel,
                    cpu_rel)
    return out


def phase_oa_parity(state: dict) -> None:
    import importlib

    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.ops import _build

    host = to_device(pool_compact(make_synthetic_batch(
        BatchSpec(4, 32, P), seed=3, bow_noise=1.0, resample=True), 128), "cpu")
    pts = host["obj_points_pooled"].transpose(1, 2).contiguous()      # [O, P, 3]
    mask = host["pooled_mask"]
    o = pts.shape[0]
    runs = {}
    for name, dev, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64)):
        runs[name] = _spct_three(dtype, dev, pts, mask)
        log(f"[oa_parity] SPCT {name}: 3 train steps {runs[name]['seconds']:.1f} s; loss "
            + ", ".join(f"{v['loss']:.6f}" for v in runs[name]["losses"]))
    ref = _spct_readings(runs["cpu64"], runs["cpu"], {})
    bounds = {k: PCT_VS_CPU * ref[k] for k in ("grad", "loss", "param", "stats", "outputs")}
    r = _spct_readings(runs["cpu64"], runs["cuda"], bounds)
    for who, x in (("CPU at f32 against the CPU at f64", ref),
                   ("card at f32 against the CPU at f64", r)):
        log(f"[oa_parity] SPCT O={o} {who}: outputs {x['outputs']:.3e}; worst gradient leaf "
            f"{x['leaf']} {x['grad']:.3e}; losses {x['loss']:.3e}; parameters "
            f"{x['param']:.3e} (most in {x['param_leaf']}); running statistics "
            f"{x['stats']:.3e}; quiet leaves left out: {x['quiet']}")
    if r["failed"]:
        raise AssertionError(f"oa_parity: the card's SPCT training is further from the f64 "
                             f"run than {PCT_VS_CPU} x the CPU's ({', '.join(r['failed'])}): {r}")

    # the ops' gradients at the same O, at both widths
    ops = {}
    for c, p in OP_WIDTHS:
        for op, bwd in (("attention", "pct_attn_bwd"), ("block", "pct_block_bwd")):
            args = op_inputs(bwd, o, torch.float32, seed=7, p=p, c=c)
            for tag, flags in (("SA", SA), ("OA", OA)):
                ops[op, tag, c] = {name: _op_grads(op, flags, dev, dtype, args)
                                   for name, dev, dtype in (("cuda", "cuda", torch.float32),
                                                            ("cpu", "cpu", torch.float32),
                                                            ("cpu64", "cpu", torch.float64))}
    failed = []
    for (op, tag, c), (rel, bound_, cpu_rel) in _op_readings(ops).items():
        log(f"[oa_parity] {op}/{tag} O={o} C={c}: gradients, card at f32 against the CPU at "
            f"f64 {rel:.3e} (bound {bound_:.3e}; the CPU at f32 {cpu_rel:.3e})")
        if not rel <= bound_:
            failed.append(f"{op}/{tag}/C={c}")
    if failed:
        raise AssertionError(f"oa_parity: the ops' gradients on the card are off: {failed}")

    mod = importlib.import_module("sgaligner_tpu_torch.ops.pct_attention")
    unseen = []
    for label, fn_name, index, factor, check in OA_PLANTED:
        kernel = getattr(mod, fn_name)
        setattr(mod, fn_name, _planted(kernel, index, factor))
        try:
            if check == "spct":
                f = _spct_readings(runs["cpu64"], _spct_three(torch.float32, "cuda", pts, mask),
                                   bounds)
                caught = f["failed"]
                what = (f"outputs {f['outputs']:.3e}, gradient {f['leaf']} {f['grad']:.3e}, "
                        f"loss {f['loss']:.3e}, parameters {f['param']:.3e}, statistics "
                        f"{f['stats']:.3e}")
            else:
                bwd = "pct_attn_bwd" if check == "attention" else "pct_block_bwd"
                faulty = {}
                for c, p in OP_WIDTHS:
                    args = op_inputs(bwd, o, torch.float32, seed=7, p=p, c=c)
                    faulty.update({(check, tag, c): _op_grads(check, flags, "cuda",
                                                              torch.float32, args)
                                   for tag, flags in (("SA", SA), ("OA", OA))})
                read = _op_readings({k: ops[k] for k in faulty}, faulty)
                caught = [f"{k[0]}/{k[1]}/C={k[2]}" for k, (rel, b, _) in read.items()
                          if not rel <= b]
                what = ", ".join(f"{k[0]}/{k[1]}/C={k[2]} {rel:.3e} (bound {b:.3e})"
                                 for k, (rel, b, _) in read.items())
        finally:
            setattr(mod, fn_name, kernel)
        log(f"[oa_parity] planted fault {label}: {what}; caught by {caught}")
        # the ops' faults must be caught at each width
        widths = [""] if check == "spct" else [f"/C={c}" for c, _ in OP_WIDTHS]
        unseen += [label + w for w in widths if not any(k.endswith(w) for k in caught)]
    if unseen:
        raise AssertionError(f"oa_parity: the planted faults {unseen} went unseen")
    state["launches_f32"] = dict(_build.LAUNCHES)  # since phase parity began


def _bench_train(state: dict, modules, tag: str, per_step: dict, dtype: str = "bfloat16",
                 windows: tuple[int, int, int] = (N_WINDOWS, WINDOW_STEPS, 5)
                 ) -> tuple[int, float, dict]:
    """bench.py's training configuration for ``modules`` (B=32, 32 slots,
    P=512, pooled bucket 128, Adam lr 1e-3, one seed-0 batch) at
    ``dtype``: warm-up, ``windows`` = (count, steps, profiled steps):
    synchronised windows with the launch counts checked against
    ``per_step``, then a profiler pass. Returns (O, median ms per step,
    launches over the windows)."""
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import create_train_state, make_train_step
    from sgaligner_tpu_torch.ops import _build

    cfg = _cfg(dtype, 32, modules)
    cfg.model.dropout = 0.0
    n_windows, window_steps, profiled = windows
    host = pool_compact(make_synthetic_batch(BatchSpec(TRAIN_B, 32, P), seed=0), 128)
    batch = to_device(host, "cuda")
    o = host["obj_points_pooled"].shape[0]
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    train = create_train_state(model, cfg)
    step = make_train_step(modules)
    t0 = time.perf_counter()
    first = step(train, batch)
    for _ in range(WARMUP_STEPS - 1):
        step(train, batch)
    torch.cuda.synchronize()
    log(f"[{tag}] O={o} pooled objects; warm-up {WARMUP_STEPS} steps "
        f"{time.perf_counter() - t0:.1f} s; loss at step 1 {float(first['loss']):.6f}")

    _build.reset_launches()
    times = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(window_steps):
            out = step(train, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    steps = n_windows * window_steps
    for name in KERNELS:
        want = per_step.get(name, 0) * steps
        if launches[name] != want:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times in "
                                 f"{steps} steps, expected {want}")
    last = {k: float(v) for k, v in out.items()}
    if not all(v == v and abs(v) < float("inf") for v in last.values()):
        raise AssertionError(f"{tag}: loss not finite: {last}")
    if not last["loss"] < float(first["loss"]):
        raise AssertionError(f"{tag}: loss did not fall ({float(first['loss'])} -> "
                             f"{last['loss']})")
    if train.skipped:
        raise AssertionError(f"{tag}: {train.skipped} steps skipped as non-finite")
    for i, w in enumerate(times):
        log(f"[{tag}] window {i}: {w / window_steps * 1e3:.2f} ms/step, "
            f"{TRAIN_B * window_steps / w:.1f} pairs/s | {state['card']}")
    profile_train(state, step, train, batch, tag, profiled)
    med = statistics.median(times)
    ms = med / window_steps * 1e3
    per = ", ".join(f"{k} {v / steps:g}" for k, v in launches.items() if v)
    log(f"[{tag}] median window {ms:.2f} ms/step, {TRAIN_B * window_steps / med:.1f} "
        f"pairs/s (B={TRAIN_B}, {dtype}, {modules[0]} config); launches per step: {per}; "
        f"loss {float(first['loss']):.6f} at step 1 -> {last['loss']:.6f} after "
        f"{WARMUP_STEPS + steps} | {state['card']}")
    return o, ms, launches


def phase_train(state: dict) -> None:
    o, ms, launches = _bench_train(state, POINT_MODULES, "train", PER_TRAIN_STEP)
    state["train_o"], state["train_step_ms"], state["launches_train"] = o, ms, launches


def phase_train_pct(state: dict) -> None:
    o, ms, launches = _bench_train(state, MODULES, "train_pct", PER_PCT_TRAIN_STEP)
    state["train_pct_o"], state["train_pct_ms"] = o, ms
    state["launches_train_pct"] = launches
    # the same step at f32, the compute dtype a pct configuration that names
    # none trains at: its tail runs the f32 forms (time_f32_forms)
    _, ms, launches = _bench_train(state, MODULES, "train_pct_f32", PER_PCT_TRAIN_STEP,
                                   "float32", F32_STEP)
    state["train_pct_f32_ms"], state["launches_train_pct_f32"] = ms, launches


def profile_train(state: dict, step, train, batch, tag: str, steps: int = 5) -> None:
    """torch.profiler over a few train steps (not the timed windows)."""
    profile_calls(state, lambda: step(train, batch), tag, steps, "step")


def profile_calls(state: dict, fn, tag: str, steps: int, unit: str) -> None:
    """torch.profiler over ``steps`` calls of ``fn`` (not the timed ones):
    the device's busy share (sum of kernel times over the wall time) and
    where the device and the host spend a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies, sets): an operator's own
    # device time repeats the time of the kernels it launched
    on_device = [e for e in events if e.device_type != torch.autograd.DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    if busy_ms <= 0:
        log(f"[{tag}] profiler: no device time recorded; busy share not measured")
        return
    kernels = sum(e.count for e in on_device)
    log(f"[{tag}] profiler, {steps} {unit}s: wall {wall_ms / steps:.2f} ms/{unit}, device busy "
        f"{busy_ms / steps:.2f} ms/{unit} ({busy_ms / wall_ms:.1%}, so idle "
        f"{1 - busy_ms / wall_ms:.1%}), {kernels / steps:.0f} device ops/{unit} | {state['card']}")
    top = sorted(on_device, key=dev_us, reverse=True)[:10]
    for e in top:
        log(f"[{tag}]   device {dev_us(e) / 1e3 / steps:8.3f} ms/{unit}  x{e.count // steps:<4d} "
            f"{e.key[:90]}")
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    for e in top:
        log(f"[{tag}]   host   {e.self_cpu_time_total / 1e3 / steps:8.3f} ms/{unit}  "
            f"x{e.count // steps:<4d} {e.key[:90]}")


def pass_split(fn, passes: tuple, calls: int = 3, attempts: int = 3) -> dict:
    """torch.profiler over ``calls`` calls of ``fn``: device ms per call of
    each kernel whose name contains one of ``passes`` (empty where the
    profiler saw no device time). Late in a long process the profiler's
    counts of some kernels fall short of their launches: a window in which
    no pass, or a pass fewer times than a whole number of calls, was seen
    is profiled again, up to ``attempts`` times, and the last window is
    kept with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CPU:
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            for name in passes:
                if name in e.key and us > 0:
                    split[name] = split.get(name, 0.0) + us / 1e3 / calls
                    counts[name] = counts.get(name, 0) + e.count
        if counts and all(n % calls == 0 for n in counts.values()):
            return split
    log(f"[time] pass_split: in {attempts} windows the profiler counted launches that no "
        f"whole number of calls makes ({counts} over {calls} calls); the split below is "
        f"not reliable")
    return split


def phase_serve_point(state: dict) -> None:
    import torch

    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import make_serving_step
    from sgaligner_tpu_torch.ops import _build

    batches = state.pop("serve_batches")
    model = build_model(_cfg("bfloat16", 32, POINT_MODULES), "cuda",
                        torch.Generator().manual_seed(0))
    step = make_serving_step(model, POINT_MODULES)
    step(batches[0])                                  # warm-up (not counted)
    torch.cuda.synchronize()
    _build.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    state["launches_serve_point"] = launches
    for name in KERNELS:
        want = len(batches) if name == "pointnet_fwd" else 0
        if launches[name] != want:
            raise AssertionError(f"serve_point: {name} launched {launches[name]} times, "
                                 f"expected {want}")
    b = batches[0]["obj_mask"].shape[0]
    for i, out in enumerate(outs):
        for k, v in out.items():
            for t in (v if isinstance(v, tuple) else (v,)):
                if not bool(torch.as_tensor(t).double().isfinite().all()):
                    raise AssertionError(f"serve_point: request {i} {k} not finite")
    med = statistics.median(times)
    log(f"[serve_point] requests " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms; median {med * 1e3:.1f} ms, {b / med:.1f} pairs/s (B={b}, bf16, point "
        f"config); MRR {float(outs[0]['rr_sum']) / int(outs[0]['rr_count']):.4f}; "
        f"launches {launches} | {state['card']}")


def _components_equal(tag: str, got: dict, want: dict) -> float:
    """The serving components of an artifact against the eager step's: the
    integer counts equal, ``rr_sum`` and ``alignment_score`` within
    ARTIFACT_RTOL relative. Returns the largest relative difference."""
    import torch

    if set(got) != set(want):
        raise AssertionError(f"{tag}: outputs {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if k in ("rr_sum", "alignment_score", "sim"):
            g, w = g.double().cpu(), w.double().cpu()
            if not bool(g.isfinite().all()):
                raise AssertionError(f"{tag}: {k} not finite")
            rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            worst = max(worst, rel)
            if not rel <= ARTIFACT_RTOL:
                raise AssertionError(f"{tag}: {k} differs from the eager step by "
                                     f"{rel:.3e} relative (> {ARTIFACT_RTOL:g})")
        else:
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                if not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"{tag}: {k} {a.tolist()} != eager {b.tolist()}")
    return worst


def _artifact_run(state: dict, tag: str, cfg, model, modules, per_request: dict,
                  queue: int = 1) -> None:
    """Export the serving step of ``model`` for the card (the pooled K pinned
    to the largest of the serve requests'), save, load, run the four serve
    requests through it (counts set to 0 just before, read just after), and
    hold them to the eager step on the same prepared batches; times both a
    request, in turns, on the same device-resident batches."""
    import tempfile

    import torch

    from sgaligner_tpu_torch import serving
    from sgaligner_tpu_torch.engine.train_step import make_serving_step, serve_queue
    from sgaligner_tpu_torch.ops import _build

    raws = state["serve_raw"]
    b = raws[0]["obj_mask"].shape[0]
    with tempfile.TemporaryDirectory(prefix="sga_artifact_") as tmp:
        t0 = time.perf_counter()
        serving.export_serving_artifact(cfg, model, tmp, batch_size=b,
                                        pooled_bucket=state["serve_o"], queue=queue)
        t_export = time.perf_counter() - t0
        size = (Path(tmp) / serving.PROGRAM).stat().st_size
        t0 = time.perf_counter()
        art = serving.load_serving_artifact(tmp)
        t_load = time.perf_counter() - t0
    prepared = [{k: v.to("cuda") for k, v in art.prepare(r).items()} for r in raws]
    if queue > 1:
        calls = [{k: torch.stack([p[k] for p in prepared]) for k in prepared[0]}]
        eager = lambda i: serve_queue(model, modules, prepared)  # noqa: E731
    else:
        calls = prepared
        step = make_serving_step(model, modules)
        eager = lambda i: step(prepared[i])  # noqa: E731
    module = art.module()
    with torch.inference_mode():
        module(calls[0])                              # warm-up (not counted)
        want = [eager(i) for i in range(len(calls))]
        torch.cuda.synchronize()
        _build.reset_launches()
        got = [module(c) for c in calls]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    _check_launches(f"artifact {tag}", launches, per_request, len(raws))
    worst = max(_components_equal(f"artifact {tag} call {i}", g, w)
                for i, (g, w) in enumerate(zip(got, want)))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t_art, t_eager = [], []
    with torch.inference_mode():
        for i in range(len(calls)):                   # eager, artifact, artifact, eager
            t_eager.append(timed(lambda: eager(i)))
            t_art.append(timed(lambda: module(calls[i])))
            t_art.append(timed(lambda: module(calls[i])))
            t_eager.append(timed(lambda: eager(i)))
        host_ms = timed(lambda: art(raws if queue > 1 else raws[0]))
    per = len(raws) / len(calls)
    art_ms, eager_ms = statistics.median(t_art) / per, statistics.median(t_eager) / per
    state.setdefault("artifact", {})[tag] = {"ms": art_ms, "eager_ms": eager_ms,
                                             "launches": launches}
    log(f"[artifact] {tag}: exported in {t_export:.1f} s ({size / 2**20:.1f} MiB), "
        f"loaded in {t_load:.1f} s; K={state['serve_o']} B={b}"
        f"{f' Q={queue}' if queue > 1 else ''}: {art_ms:.2f} ms a request "
        f"({b / art_ms * 1e3:.1f} pairs/s) against the eager step's {eager_ms:.2f} ms "
        f"(median of the turns, device-resident batches); one call from host "
        f"batches (prepare, copy, run) {host_ms:.1f} ms; worst relative difference "
        f"{worst:.3e}; launches {({k: v for k, v in launches.items() if v})} | "
        f"{state['card']}")


def phase_artifact(state: dict) -> None:
    """The serving artifact (serving.py) on the card: the pct serving step
    at full width, single and queue (Q = ARTIFACT_Q), and the point
    configuration; then a request prepare must refuse."""
    import torch

    from sgaligner_tpu_torch import serving
    from sgaligner_tpu_torch.engine.factory import build_model

    pct = build_model(_cfg("bfloat16", 32), "cuda", torch.Generator().manual_seed(0))
    _artifact_run(state, "pct", _cfg("bfloat16", 32), pct, MODULES, PER_REQUEST)
    _artifact_run(state, "pct queue", _cfg("bfloat16", 32), pct, MODULES,
                  PER_REQUEST, queue=ARTIFACT_Q)
    del pct
    point = build_model(_cfg("bfloat16", 32, POINT_MODULES), "cuda",
                        torch.Generator().manual_seed(0))
    _artifact_run(state, "point", _cfg("bfloat16", 32, POINT_MODULES), point,
                  POINT_MODULES, {"pointnet_fwd": 1})
    state.pop("serve_raw")
    torch.cuda.empty_cache()
    # a batch whose every slot is real pools past the pinned K: refused
    import tempfile

    cfg = _cfg("bfloat16", 8, POINT_MODULES)
    with tempfile.TemporaryDirectory(prefix="sga_artifact_") as tmp:
        serving.export_serving_artifact(cfg, build_model(cfg, "cuda"), tmp,
                                        batch_size=4, pooled_bucket=16)
        art = serving.load_serving_artifact(tmp)
    from sgaligner_tpu_torch.data.batch import BatchSpec
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch

    host = make_synthetic_batch(BatchSpec(4, 8, P), seed=5)
    host["obj_mask"][:] = True
    try:
        art.prepare(host)
    except ValueError as e:
        if "pooled_bucket" not in str(e):
            raise
        log(f"[artifact] a request past the pinned K refused: {e}")
    else:
        raise AssertionError("artifact: prepare took a batch past the pinned K")


def ransac_problem(seed: int, n: int = RANSAC_N, inliers: float = RANSAC_INLIERS):
    """Correspondences under a known rigid transform: a share ``inliers``
    moved by it (noise 3 mm), the rest uniform in the same box. Returns
    (src, ref, transform, inlier mask), float32 and float64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    r *= np.sign(np.linalg.det(r))
    t = rng.normal(size=3)
    src = rng.uniform(-2, 2, size=(n, 3))
    ref = src @ r.T + t
    inl = rng.random(n) < inliers
    ref[~inl] = rng.uniform(-2, 2, size=(int((~inl).sum()), 3)) + t
    ref[inl] += rng.normal(0, 0.003, size=(int(inl.sum()), 3))
    tf = np.eye(4)
    tf[:3, :3], tf[:3, 3] = r, t
    return src.astype(np.float32), ref.astype(np.float32), tf, inl


def _ransac_sides(src, ref, seed: int) -> dict:
    """RANSAC on the CPU and on the card on the same draw: {device:
    (transform float64, inlier count)}."""
    import torch

    from sgaligner_tpu_torch.reg import ransac

    out = {}
    for dev in ("cpu", "cuda"):
        s, r, m = ransac._padded(src, ref, dev)
        tf, n = ransac.ransac_rigid_transform(s, r, m, seed, iters=RANSAC_ITERS)
        out[dev] = (tf.cpu().double().numpy(), int(n))
    torch.cuda.synchronize()
    return out


def _ransac_agree(sides: dict, what: str) -> float:
    import numpy as np

    (tf_c, n_c), (tf_g, n_g) = sides["cpu"], sides["cuda"]
    diff = float(np.abs(tf_g - tf_c).max())
    if not diff <= REG_TF_ABS or n_c != n_g:
        raise AssertionError(f"register {what}: card transform {diff:.3e} from the "
                             f"CPU's (bound {REG_TF_ABS:g}), inliers {n_g} vs {n_c}")
    return diff


def phase_register(state: dict) -> None:
    """The classical registration stack on the card: RANSAC at the
    reference's size against the CPU on the same draw (then with a planted
    fault), ICP against the CPU, and Aligner.align(register=True) on a
    synthetic scene pair."""
    import tempfile

    import numpy as np
    import torch

    from sgaligner_tpu_torch import api
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.reg import icp, ransac
    from sgaligner_tpu_torch.reg.metrics import compute_registration_error

    src, ref, tf_true, inl = ransac_problem(7)
    t0 = time.perf_counter()
    sides = _ransac_sides(src, ref, seed=3)
    diff = _ransac_agree(sides, "ransac")
    rre, rte = compute_registration_error(tf_true, sides["cuda"][0])
    if not (rre < 0.1 and rte < 0.01):
        raise AssertionError(f"register: RANSAC missed the known transform "
                             f"(RRE {rre:.3e} deg, RTE {rte:.3e})")
    times = {}
    s64, r64, m = ransac._padded(src, ref, "cuda")
    for dtype in (torch.float64, torch.float32):
        s, r = s64.to(dtype), r64.to(dtype)
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ransac.ransac_rigid_transform(s, r, m, 3, iters=RANSAC_ITERS)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1) * 1e3)
        times[str(dtype).removeprefix("torch.")] = runs[1:]
    ms = statistics.median(times["float64"])
    state["ransac_ms"] = ms
    log(f"[register] RANSAC N={RANSAC_N} ({RANSAC_INLIERS:.0%} inliers, {int(inl.sum())}) "
        f"x {RANSAC_ITERS} hypotheses, float64 (find_rigid_transform's): card "
        f"{ms:.2f} ms (median of 5, the CPU draw included; runs "
        + ", ".join(f"{t:.2f}" for t in times["float64"]) + "); inputs cast to float32 "
        f"{statistics.median(times['float32']):.2f} ms; card vs CPU transform "
        f"{diff:.3e}, inliers {sides['cuda'][1]} / {sides['cpu'][1]}; RRE {rre:.2e} deg "
        f"RTE {rte:.2e} | {state['card']}")
    profile_calls(state, lambda: ransac.ransac_rigid_transform(s64, r64, m, 3, iters=RANSAC_ITERS),
                  "register", 3, "RANSAC call")

    kabsch = ransac.kabsch

    def transposed(a, b, w=None):      # the planted fault: Rᵀ from the card
        tf = kabsch(a, b, w)
        if a.is_cuda:
            tf = tf.clone()
            tf[..., :3, :3] = tf[..., :3, :3].transpose(-1, -2)
        return tf

    ransac.kabsch = transposed
    try:
        caught = False
        try:
            _ransac_agree(_ransac_sides(src, ref, seed=3), "planted")
        except AssertionError as e:
            caught = True
            log(f"[register] planted fault (the card's Kabsch returns Rᵀ) caught: {e}")
    finally:
        ransac.kabsch = kabsch
    if not caught:
        raise AssertionError("register: the planted Kabsch fault was not caught")

    rng = np.random.default_rng(11)
    cloud = rng.uniform(-2, 2, size=(8192, 3)).astype(np.float32)
    ang = np.radians(4.0)
    tf_icp = np.eye(4)
    tf_icp[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    tf_icp[:3, 3] = [0.03, -0.02, 0.01]
    moved = (cloud @ tf_icp[:3, :3].T + tf_icp[:3, 3]).astype(np.float32)
    icp_out = {dev: icp.icp_refine_host(cloud, moved, iters=ICP_ITERS,
                                        max_corr_dist=0.2, device=dev)
               for dev in ("cpu", "cuda")}
    d_icp = float(np.abs(icp_out["cuda"][0] - icp_out["cpu"][0]).max())
    d_rmse = abs(icp_out["cuda"][1] - icp_out["cpu"][1])
    rre_i, rte_i = compute_registration_error(tf_icp, icp_out["cuda"][0])
    log(f"[register] icp_refine 8192 x 8192 points, {ICP_ITERS} iterations: card vs "
        f"CPU transform {d_icp:.3e}, rmse {icp_out['cuda'][1]:.3e} / "
        f"{icp_out['cpu'][1]:.3e}; card RRE {rre_i:.2e} deg RTE {rte_i:.2e}")
    if not (d_icp <= REG_TF_ABS and d_rmse <= REG_TF_ABS):
        raise AssertionError(f"register: icp card vs CPU {d_icp:.3e} / {d_rmse:.3e}")

    with tempfile.TemporaryDirectory(prefix="sga_register_") as tmp:
        make_synthetic_workspace(tmp, split="val", n_pairs=1, pts_per_obj=ALIGN_PTS)
        scenes = [str(Path(tmp) / "scans" / f"scene00_{side}" / "data.npy")
                  for side in ("src", "ref")]
        cfg = make_cfg(model_name="sgaligner", modules=["point"])
        aligners = {dev: api.load_aligner(cfg, device=dev) for dev in ("cuda", "cpu")}
        res = {"cpu": aligners["cpu"].align(*scenes, register=True)}
        aligners["cuda"].align(*scenes, register=True)          # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t1 = time.perf_counter()
        res["cuda"] = aligners["cuda"].align(*scenes, register=True)
        t_align = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
    _check_launches("register align", launches, {"pointnet_fwd": 1}, 1)
    got, want = res["cuda"], res["cpu"]
    rre, rte = compute_registration_error(np.eye(4), got.transform)
    d_align = float(np.abs(got.transform - want.transform).max())
    log(f"[register] Aligner.align(register=True), pc_res {cfg.val.pc_res}, "
        f"{cfg.reg_model.ransac_max_iters} hypotheses, {ALIGN_PTS} points an object: "
        f"{len(got.node_matches)} node matches, RRE {rre:.3e} deg RTE {rte:.3e} (bounds "
        f"5, 0.1), card vs CPU transform {d_align:.3e}; {t_align * 1e3:.1f} ms a call "
        f"(warm, host clock) | launches {({k: v for k, v in launches.items() if v})} | "
        f"{state['card']}")
    if not (rre < 5.0 and rte < 0.1):
        raise AssertionError(f"register: align(register=True) RRE {rre} RTE {rte}")
    if got.node_matches != want.node_matches or not d_align <= REG_TF_ABS:
        raise AssertionError(f"register: align on the card vs the CPU: matches "
                             f"{got.node_matches} vs {want.node_matches}, transform "
                             f"{d_align:.3e}")
    log(f"[register] {time.perf_counter() - t0:.1f} s")


def registration_run(root: str, device: str) -> dict:
    """The ``full`` snapshot's AlignRegTester with registration (the
    classical backend, reg_model's defaults) over the val workspace at
    ``root``, at f32 on ``device``."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.engine.tester import AlignRegTester
    from sgaligner_tpu_torch.reg.backend import build_backend
    from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator

    q = snapshot_quality("full")
    values = quality_cfg(root, q["modules"])
    values["registration"] = True
    cfg = make_cfg(**values)
    loader = get_val_dataloader(cfg)
    evaluator = RegistrationEvaluator(cfg, build_backend(cfg, device=device))
    tester = AlignRegTester(cfg, loader.dataset, loader,
                            registration_evaluator=evaluator,
                            snapshot=torch_snapshot("full"), device=device)
    return tester.run()


def gt_correspondences(root: str) -> list[int]:
    """For each val pair of the workspace at ``root``, the GT point
    correspondences the tester gives the recall: src points within 1e-7 of a
    ref point, both centred on the src scan (identity pairs)."""
    import numpy as np

    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.utils.io import load_plydata_npy
    from sgaligner_tpu_torch.utils.pointcloud import compute_pcl_overlap

    ds = get_val_dataloader(make_cfg(**quality_cfg(root, ["point"]))).dataset
    counts = []
    for i in range(len(ds)):
        src, ref = (load_plydata_npy(str(Path(ds.scans_scenes_dir) / scan / "data.npy"))
                    for scan in ds.pair_scan_ids(i))
        if not np.allclose(ds.pair_gt_transform(i), np.eye(4)):
            raise AssertionError(f"quality registration: pair {i} is not at identity")
        c = src.mean(axis=0)
        counts.append(len(compute_pcl_overlap(src - c, ref - c, 1e-7)[1]))
    return counts


def quality_registration(state: dict, root: str) -> None:
    """Registration of the ``full`` snapshot over the val split on the card
    and on the CPU: each summary's metrics within REG_SUMMARY_ABS."""
    counts = gt_correspondences(root)
    log(f"[quality] GT correspondences (within 1e-7) a val pair: {counts}"
        + (": none, so recall is 0 on both sides by construction and its "
           "comparison checks nothing" if not any(counts) else ""))
    readings = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got = registration_run(root, dev)
        readings[dev] = got
        log(f"[quality] full registration on {dev} ({time.perf_counter() - t0:.1f} s): "
            + "; ".join(f"{kind} " + ", ".join(f"{k} {v:.6f}" for k, v in got[kind].items())
                        for kind in ("normal_registration", "aligner_registration"))
            + f" | {state['card']}")
    for kind in ("normal_registration", "aligner_registration"):
        card, cpu = readings["cuda"][kind], readings["cpu"][kind]
        if set(card) != set(cpu) or not card:
            raise AssertionError(f"quality registration: {kind} keys {sorted(card)} "
                                 f"vs {sorted(cpu)}")
        off = {k: (card[k], cpu[k]) for k in cpu if not abs(card[k] - cpu[k]) <= REG_SUMMARY_ABS}
        if off:
            raise AssertionError(f"quality registration: {kind} card vs CPU beyond "
                                 f"{REG_SUMMARY_ABS}: {off}")
    state["registration"] = readings["cuda"]


def _check_launches(tag: str, launches: dict, per_call: dict, calls: int) -> None:
    for name in (*KERNELS, *WIDE):
        want = per_call.get(name, 0) * calls
        if launches[name] != want:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times in "
                                 f"{calls} calls, expected {want}")


def phase_spct(state: dict) -> None:
    """SPCT at full width on bench.py's pct training batch (B=32, 32 slots,
    P=512, bf16, pooled bucket 128, seed 0): the eval forward, and the
    train-mode forward plus backward of a seeded-cotangent loss over its
    three outputs; ms per call and the launches per call."""
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import init_weights
    from sgaligner_tpu_torch.models.pct import SPCT
    from sgaligner_tpu_torch.ops import _build

    host = pool_compact(make_synthetic_batch(BatchSpec(TRAIN_B, 32, P), seed=0), 128)
    batch = to_device(host, "cuda")
    pts = batch["obj_points_pooled"].transpose(1, 2)                 # [O, P, 3]
    mask = batch["pooled_mask"]
    o = pts.shape[0]
    net = SPCT(torch.bfloat16)
    init_weights(net, torch.Generator().manual_seed(0))
    net.cuda()

    def finite(outs, what):
        for t in outs:
            if not bool(t.isfinite().all()):
                raise AssertionError(f"spct: {what} not finite")

    net.eval()
    with torch.inference_mode():
        outs = net(pts, mask)                                        # warm-up
        shapes = [tuple(t.shape) for t in outs]
        if shapes != [(o, P, 1024), (o, 1024), (o, 1024)]:
            raise AssertionError(f"spct: output shapes {shapes}")
        finite(outs, "eval outputs")
        torch.cuda.synchronize()
        _build.reset_launches()
        eval_times = []
        for _ in range(SPCT_EVAL_CALLS):
            t0 = time.perf_counter()
            net(pts, mask)
            torch.cuda.synchronize()
            eval_times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
    _check_launches("spct eval", launches, PER_SPCT_EVAL, SPCT_EVAL_CALLS)
    state["launches_spct_eval"] = launches
    eval_ms = statistics.median(eval_times)

    net.train()
    g = torch.Generator().manual_seed(5)
    cts = [torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)
           for shape in ((o, P, 1024), (o, 1024), (o, 1024))]

    def fwd_bwd():
        net.zero_grad(set_to_none=True)
        outs = net(pts, mask)
        torch.autograd.backward(outs, cts)
        return outs

    finite(fwd_bwd(), "train outputs")                               # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for _ in range(SPCT_TRAIN_CALLS):
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    _check_launches("spct train", launches, PER_SPCT_TRAIN, SPCT_TRAIN_CALLS)
    state["launches_spct_train"] = launches
    finite([q.grad for q in net.parameters()], "gradients")
    train_ms = statistics.median(times)
    profile_calls(state, fwd_bwd, "spct", 3, "call")
    state["spct_o"], state["spct_ms"] = o, (eval_ms, train_ms)
    log(f"[spct] O={o} bf16: eval forward {', '.join(f'{t:.2f}' for t in eval_times)} ms, "
        f"median {eval_ms:.2f} ms; train forward + backward "
        f"{', '.join(f'{t:.2f}' for t in times)} ms, median {train_ms:.2f} ms; launches per "
        f"call: eval {PER_SPCT_EVAL}, train {PER_SPCT_TRAIN} | {state['card']}")


def _ops_flag_set(state: dict, tag: str, flags, o: int, dtype, dt_name: str, p: int = P,
                  c: int = C) -> dict:
    """pct_attention_fused and pct_block_fused forward plus backward through
    autograd with one flag set at width c on the card, the launches counted
    from 0 over their two calls (one of each of their kernels, the _c256
    ones at C = 256), then each held to its plain versions on the same
    inputs. Returns the launches."""
    import torch

    from sgaligner_tpu_torch.ops import _build, pct_attention

    suffix = pct_attention.WIDTHS[c]
    runs = {}
    _build.reset_launches()
    for op, fwd, bwd in (("attention", "pct_attn_fwd", "pct_attn_bwd"),
                         ("block", "pct_block_fwd", "pct_block_bwd")):
        args = op_inputs(bwd, o, dtype, seed=4, p=p, c=c)
        n = 4 if op == "attention" else 6
        extra = args[n:n + 1] if op == "block" else ()
        leaves = [a.clone().requires_grad_(True) for a in args[:n]]
        fn = pct_attention.pct_attention_fused if op == "attention" else \
            pct_attention.pct_block_fused
        t0 = time.perf_counter()
        outs = as_tuple(fn(*leaves, *extra, *flags))
        grads = torch.autograd.grad(outs, leaves, args[n + len(extra):])
        torch.cuda.synchronize()
        runs[op] = (args, n, extra, outs, grads, fwd, bwd, time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    _check_launches(f"ops/{tag}/C={c}/{dt_name}", launches,
                    {k + suffix: 1 for k in ("pct_attn_fwd", "pct_attn_bwd", "pct_block_fwd",
                                             "pct_block_bwd")}, 1)
    for op, (args, n, extra, outs, grads, fwd, bwd, secs) in runs.items():
        plain_f, plain_b = op_fns(fwd, flags)[1], op_fns(bwd, flags)[1]
        f_abs, f_rel = judge(fwd, dt_name, flags, args[:n] + tuple(extra),
                             tuple(t.detach() for t in outs),
                             as_tuple(plain_f(*args[:n], *extra)), plain_f,
                             f"ops: {fwd}{suffix}/{tag}/{dt_name}")
        want_b = as_tuple(plain_b(*args))
        got_b = tuple(g.reshape(w.shape) for g, w in zip(grads, want_b))
        b_abs, b_rel = judge(bwd, dt_name, flags, args, got_b, want_b, plain_b,
                             f"ops: {bwd}{suffix}/{tag}/{dt_name}")
        log(f"[ops] {op}/{tag} O={o} P={p} C={c} {dt_name}: forward + backward "
            f"{secs * 1e3:.1f} ms (first call); against the plain versions: forward max_rel "
            f"{f_rel:.3e}, gradients max_rel {b_rel:.3e}; launches "
            f"{ {k: v for k, v in launches.items() if v} } | {state['card']}")
    del runs
    torch.cuda.empty_cache()
    return launches


def phase_ops(state: dict) -> None:
    """pct_attention_fused and pct_block_fused, forward plus backward
    through autograd, SA then OA, on the card against their plain versions
    on the same inputs: at the training O (C = 128, bf16), then at
    FullPCT's layout (O = 256, P = C = 256) in f32 and bf16. The launches of
    each flag set are counted from 0 over its two op calls."""
    import torch

    state["launches_ops"] = {tag: _ops_flag_set(state, tag, flags, state["spct_o"],
                                                torch.bfloat16, "bf16")
                             for tag, flags in (("SA", SA), ("OA", OA))}
    state["launches_ops_c256"] = {
        dt_name: {tag: _ops_flag_set(state, tag, flags, WIDE_O, dtype, dt_name, WIDE_P, WIDE_C)
                  for tag, flags in (("SA", SA), ("OA", OA))}
        for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}


def full_pct_batch(pairs: int, seed: int):
    """FullPCT's input on the CPU: ``pairs`` pairs of the BENCH layout
    (FULL_PCT_SLOTS slots a graph, FULL_PCT_VALID valid objects, the padded
    slots' points zeros) at FULL_PCT_N points an object: (points [O, N, 3],
    mask [O]), O = 2 · FULL_PCT_SLOTS a pair."""
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch

    host = make_synthetic_batch(BatchSpec(pairs, FULL_PCT_SLOTS, FULL_PCT_N), seed=seed,
                                n_src=FULL_PCT_VALID, n_ref=FULL_PCT_VALID, resample=True)
    pts = torch.from_numpy(host["obj_points"]).flatten(0, 1).transpose(1, 2).contiguous()
    return pts, torch.from_numpy(host["obj_mask"]).flatten()


@contextlib.contextmanager
def grouping_indices(record: list, replay: list | None = None):
    """Patch the KNN grouping's FPS and KNN (ops/knn.py): append each
    call's indices to ``record`` (on the host) and, with ``replay``, use the
    recorded ones instead, in call order. Both pick by comparing distances,
    and a near-tie may fall either way on two devices or dtypes; a CPU run
    that replays the card's picks groups the same points."""
    from sgaligner_tpu_torch.ops import knn as mod

    fps, knn_point, queue = mod.farthest_point_sample, mod.knn_point, iter(replay or ())

    def routed(fn):
        def call(*args, **kwargs):
            idx = fn(*args, **kwargs)
            record.append(idx.cpu())
            return idx if replay is None else next(queue).to(idx.device)
        return call

    mod.farthest_point_sample, mod.knn_point = routed(fps), routed(knn_point)
    try:
        yield
    finally:
        mod.farthest_point_sample, mod.knn_point = fps, knn_point


def _full_pct_three(dtype, dev: str, pts, mask) -> dict:
    """FullPCT's eval output, then three Adam steps (lr 1e-3) in train mode
    from the seeded weights (``build_full_pct``, seed 11; head dropout off)
    on the loss <out, ct> with a seeded cotangent: _spct_three's readings,
    "outputs" the eval output and the first train step's."""
    import torch

    from sgaligner_tpu_torch.engine.factory import build_full_pct

    net = build_full_pct("cpu", dtype, seed=11, samples=FULL_PCT_SAMPLES)
    net = net.to(dev, torch.float64) if dtype == torch.float64 else net.to(dev)
    net.dropout = 0.0
    pts, mask = pts.to(dev), mask.to(dev)
    start = {k: v.detach().double().cpu().clone() for k, v in net.state_dict().items()}
    t0 = time.perf_counter()
    net.eval()
    with torch.no_grad():
        outputs = [net(pts, mask).double().cpu()]
    net.train()
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    ct = torch.randn(pts.shape[0], 256, generator=torch.Generator().manual_seed(5)).to(dev, dtype)
    losses = []
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        out = net(pts, mask)
        loss = (out * ct).sum()
        loss.backward()
        if step == 0:
            outputs.append(out.detach().double().cpu())
            grads = {k: q.grad.double().cpu() for k, q in net.named_parameters()}
        opt.step()
        losses.append({"loss": float(loss.detach())})
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "outputs": outputs, "start": start,
            "seconds": time.perf_counter() - t0,
            "params": {k: v.detach().double().cpu() for k, v in net.state_dict().items()}}


def phase_full_pct(state: dict) -> None:
    """FullPCT through the port (models.pct.FullPCT: FPS + KNN grouping,
    SGModule, four OA blocks at C = 256 on the kernels of WIDE). First its
    eval output and three train steps at O = 32 on the card at f32 and on the
    CPU at f32 and f64, the CPU runs replaying the card's FPS and KNN picks,
    held by oa_parity's rule (PCT_VS_CPU times the CPU's own f32 distance
    from f64). Then at full width, O = 256, on the card at f32 and bf16:
    the eval forward and the train forward plus backward (head dropout on),
    ms a call (CUDA events, median of FULL_PCT_CALLS), the C = 256 kernels'
    launches a call, finite outputs and gradients, peak memory. At bf16 FPS
    and KNN pick on bf16 coordinates, so that run is held by its kernels
    (phase kernels) and its finiteness, not against f32."""
    import torch

    from sgaligner_tpu_torch.engine.factory import build_full_pct
    from sgaligner_tpu_torch.ops import _build

    pts, mask = full_pct_batch(FULL_PCT_PARITY_PAIRS, seed=21)
    o = pts.shape[0]
    idx = {"cuda": [], "cpu": [], "cpu64": []}
    runs = {}
    for name, dev, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64)):
        with grouping_indices(idx[name], None if name == "cuda" else idx["cuda"]):
            runs[name] = _full_pct_three(dtype, dev, pts, mask)
        log(f"[full_pct] {name}: eval + 3 train steps {runs[name]['seconds']:.1f} s; loss "
            + ", ".join(f"{v['loss']:.6f}" for v in runs[name]["losses"]))
    apart = [int((a != b).sum()) for a, b in zip(idx["cpu"], idx["cuda"])]
    ref = _spct_readings(runs["cpu64"], runs["cpu"], {})
    bounds = {k: PCT_VS_CPU * ref[k] for k in ("grad", "loss", "param", "stats", "outputs")}
    r = _spct_readings(runs["cpu64"], runs["cuda"], bounds)
    log(f"[full_pct] O={o} N={FULL_PCT_N}: FPS / KNN indices the CPU at f32 picks apart from "
        f"the card, per call (replayed): {apart} of "
        f"{[int(t.numel()) for t in idx['cuda']]}")
    for who, x in (("CPU at f32 against the CPU at f64", ref),
                   ("card at f32 against the CPU at f64", r)):
        log(f"[full_pct] O={o} {who}: outputs {x['outputs']:.3e}; worst gradient leaf "
            f"{x['leaf']} {x['grad']:.3e}; losses {x['loss']:.3e}; parameters "
            f"{x['param']:.3e} (most in {x['param_leaf']}); running statistics "
            f"{x['stats']:.3e}; quiet leaves left out: {x['quiet']}")
    if r["failed"]:
        raise AssertionError(f"full_pct: the card's FullPCT is further from the f64 run than "
                             f"{PCT_VS_CPU} x the CPU's ({', '.join(r['failed'])}): {r}")
    del runs, idx

    pts, mask = full_pct_batch(FULL_PCT_PAIRS, seed=22)
    pts, mask = pts.cuda(), mask.cuda()
    o = pts.shape[0]
    state["launches_full_pct"], state["full_pct_ms"] = {}, {}

    def finite(tensors, what):
        if not all(bool(t.isfinite().all()) for t in tensors):
            raise AssertionError(f"full_pct: {what} not finite")

    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = build_full_pct("cuda", dtype, seed=11, samples=FULL_PCT_SAMPLES)
        net.eval()
        with torch.inference_mode():
            out = net(pts, mask)                                         # warm-up
            if tuple(out.shape) != (o, 256) or out.dtype != dtype:
                raise AssertionError(f"full_pct: output {tuple(out.shape)} {out.dtype}")
            finite([out], f"eval output ({dt_name})")
            torch.cuda.synchronize()
            _build.reset_launches()
            eval_ms = cuda_ms(lambda: net(pts, mask), warmup=0, reps=FULL_PCT_CALLS)
            eval_launches = dict(_build.LAUNCHES)
        _check_launches(f"full_pct eval/{dt_name}", eval_launches, PER_FULL_PCT_EVAL,
                        FULL_PCT_CALLS)
        net.train()
        drop = torch.Generator(device="cuda").manual_seed(7)
        ct = torch.randn(o, 256, generator=torch.Generator().manual_seed(5)).to("cuda", dtype)

        def fwd_bwd():
            net.zero_grad(set_to_none=True)
            out = net(pts, mask, drop)
            out.backward(ct)
            return out

        torch.cuda.reset_peak_memory_stats()
        finite([fwd_bwd()], f"train output ({dt_name})")                  # warm-up
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        _build.reset_launches()
        train_ms = cuda_ms(fwd_bwd, warmup=0, reps=FULL_PCT_CALLS)
        train_launches = dict(_build.LAUNCHES)
        _check_launches(f"full_pct train/{dt_name}", train_launches, PER_FULL_PCT_TRAIN,
                        FULL_PCT_CALLS)
        finite([q.grad for q in net.parameters()], f"gradients ({dt_name})")
        if dt_name == "f32":
            # the device's busy share of a train call: how much is host work
            # (FPS's picks, the launches)
            profile_calls(state, fwd_bwd, "full_pct f32 train", steps=2, unit="call")
        state["launches_full_pct"][dt_name] = {"eval": eval_launches, "train": train_launches}
        state["full_pct_ms"][dt_name] = (eval_ms, train_ms)
        log(f"[full_pct] O={o} N={FULL_PCT_N} samples {FULL_PCT_SAMPLES} {dt_name}: eval forward "
            f"{eval_ms:.2f} ms, train forward + backward {train_ms:.2f} ms a call (median of "
            f"{FULL_PCT_CALLS}); peak memory in training {peak_gb:.1f} GiB; launches a call: "
            f"eval {PER_FULL_PCT_EVAL}, train {PER_FULL_PCT_TRAIN} | {state['card']}")
        del net, out, ct
        torch.cuda.empty_cache()


def snapshot_quality(name: str) -> dict:
    """checkpoints/aligner_<name>/quality.json."""
    with open(CHECKPOINTS / f"aligner_{name}" / "quality.json") as f:
        return json.load(f)


def torch_snapshot(name: str) -> str:
    return str(CHECKPOINTS / "torch" / f"aligner_{name}.pth.tar")


def quality_cfg(root: str, modules, model_name: str = "sgaligner") -> dict:
    """The config write_cfg writes for the tester (no LR schedule, the loss
    as best metric), as a dict for core.config.make_cfg."""
    return {
        "seed": 42, "num_workers": 2, "model_name": model_name,
        "modules": list(modules), "scan_type": "subscan",
        "data": {"name": "Scan3R", "subscan_dir": root},
        "preprocess": {"pc_resolutions": [512], "min_obj_points": 10},
        "train": {"batch_size": 8, "pc_res": 512},
        "val": {"batch_size": 8, "pc_res": 512},
        "optim": {"max_epoch": MAX_EPOCH, "lr": 1e-3},
        "tpu": {"max_objects": 16, "points_per_object": 512, "dp": 1},
    }


def build_val_workspace(root: str, q: dict) -> dict:
    """The held-out val workspace a quality.json pins (its bench, val_seed
    and n_val_pairs), written under root."""
    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace

    return make_synthetic_workspace(root, split="val", n_pairs=q["n_val_pairs"],
                                    seed=q["val_seed"], **q["bench"])


def quality_run(name: str, root: str, device: str = "cuda", dtype: str = "float32",
                bucket: int = 0) -> tuple[dict, list[float], int, tuple]:
    """One tracked snapshot through the port's tester on the val workspace
    at ``root``: the config as a dict (write_cfg's values), the weights from
    its .pth.tar copy. Returns (results, ms per request, the PointNet's
    C3, a copy of the PointNet forward's inputs on the first request); a
    request is one eval step on a batch of 8 pairs."""
    import torch

    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.engine.tester import AlignRegTester
    from sgaligner_tpu_torch.models import pointnet

    q = snapshot_quality(name)
    values = quality_cfg(root, q["modules"], q.get("model_name", "sgaligner"))
    values["tpu"].update(compute_dtype=dtype, pooled_bucket=bucket)
    cfg = make_cfg(**values)
    loader = get_val_dataloader(cfg)
    tester = AlignRegTester(cfg, loader.dataset, loader,
                            snapshot=torch_snapshot(name), device=device)
    step, times = tester.eval_step, []
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(batch):
        sync()
        t0 = time.perf_counter()
        out = step(batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    first, fwd = [], pointnet.pointnet_fwd

    def kept(*args, **kw):
        if not first:
            first.append(tuple(a.clone() for a in args))
        return fwd(*args, **kw)

    tester.eval_step, pointnet.pointnet_fwd = timed, kept
    try:
        results = tester.run()
    finally:
        pointnet.pointnet_fwd = fwd
    return results, times, tester.model.object_encoder.conv3.weight.shape[0], first[0]


def phase_quality(state: dict) -> None:
    """The tracked trained snapshots through the port's tester on the card
    (f32 in the tester's own layout, held to quality.json; bf16 pooled, a
    reading). Counts are set to 0 before each run and read after it; then
    the first request's PointNet forward is held against its plain
    version on the same inputs."""
    import tempfile

    from sgaligner_tpu_torch.ops import _build

    readings, state["quality_ms"] = {}, {}
    with tempfile.TemporaryDirectory(prefix="sga_quality_") as tmp:
        built: dict[str, str] = {}
        for name in SNAPSHOTS:
            q = snapshot_quality(name)
            key = json.dumps([q["bench"], q["val_seed"], q["n_val_pairs"]])
            if key not in built:
                built[key] = str(Path(tmp) / f"ws{len(built)}")
                t0 = time.perf_counter()
                build_val_workspace(built[key], q)
                log(f"[quality] val workspace (seed {q['val_seed']}, {q['n_val_pairs']} "
                    f"pairs) built in {time.perf_counter() - t0:.1f} s")
            pinned = q["results"]
            for dtype, bucket in (("float32", 0), ("bfloat16", QUALITY_BUCKET)):
                _build.reset_launches()
                got, times, c3, args = quality_run(name, built[key], "cuda", dtype, bucket)
                launches = dict(_build.LAUNCHES)
                # the first request's PointNet forward again, against its plain
                # version on the same inputs (after the counts were read)
                dt_name = "f32" if dtype == "float32" else "bf16"
                label = f"quality {name} pointnet_fwd/C3={c3}/{dt_name}"
                err_abs, err_rel = check_op("pointnet_fwd", args, dt_name, what=label)
                log(f"[quality] {label}: O={args[0].shape[0]} P={args[0].shape[2]} "
                    f"max_abs={err_abs:.3e} max_rel={err_rel:.3e} (tol "
                    f"{tol('pointnet_fwd', dt_name):g})")
                batches = -(-q["n_val_pairs"] // 8)
                want = {k: (batches if k == "pointnet_fwd" else 0)
                        for k in (*KERNELS, *WIDE)}
                if launches != want:
                    raise AssertionError(f"quality {name} {dtype}: launches {launches}, "
                                         f"expected pointnet_fwd {batches} and no other")
                if name == "eva" and c3 != EVA_C3:
                    raise AssertionError(f"quality eva: PointNet C3 = {c3}, expected {EVA_C3}")
                gaps = {k: got[k] - pinned[k] for k in QUALITY_KEYS}
                log(f"[quality] {name} {dtype}{' pooled ' + str(bucket) if bucket else ''}: "
                    + ", ".join(f"{k} {got[k]:.4f} (quality.json {pinned[k]:.4f}, gap "
                                f"{gaps[k]:+.4f})" for k in QUALITY_KEYS)
                    + f"; sgar@2/50/100 {got['sgar@2']:.3f}/{got['sgar@50']:.3f}/"
                    f"{got['sgar@100']:.3f}; pointnet_fwd C3 = {c3}, {launches['pointnet_fwd']} "
                    f"launches; requests (8 pairs) " + ", ".join(f"{t:.2f}" for t in times)
                    + f" ms | {state['card']}")
                state["quality_ms"][(name, dtype)] = statistics.median(times)
                if name == "eva":
                    state.setdefault("launches_quality_eva", 0)
                    state["launches_quality_eva"] += launches["pointnet_fwd"]
                if dtype == "float32":
                    readings[name] = got
                    off = {k: g for k, g in gaps.items()
                           if not abs(g) <= QUALITY_ABS}
                    if off:
                        raise AssertionError(f"quality {name} f32: {off} beyond "
                                             f"{QUALITY_ABS} of quality.json")
                elif any(abs(g) > QUALITY_ABS for g in gaps.values()):
                    log(f"[quality] {name} bfloat16: a gap beyond {QUALITY_ABS} "
                        "(a reading, not a check)")
        q = snapshot_quality("full")
        quality_registration(state, built[json.dumps([q["bench"], q["val_seed"],
                                                      q["n_val_pairs"]])])
    eva, full = readings["eva"], readings["full"]
    if not (eva["mrr"] < full["mrr"] and eva["hits@1"] < full["hits@1"]):
        raise AssertionError(f"quality: EVA (mrr {eva['mrr']:.4f}, hits@1 "
                             f"{eva['hits@1']:.4f}) is not below full (mrr "
                             f"{full['mrr']:.4f}, hits@1 {full['hits@1']:.4f})")
    log("[quality] EVA below full at f32: mrr "
        f"{eva['mrr']:.4f} < {full['mrr']:.4f}, hits@1 {eva['hits@1']:.4f} < "
        f"{full['hits@1']:.4f}")


def registered_hit(out, gt) -> bool:
    """Whether a registration hits (eval_geo's rule; a declined pair
    misses)."""
    from sgaligner_tpu_torch.reg.eval_geo import is_hit
    from sgaligner_tpu_torch.reg.metrics import compute_registration_error

    return out is not None and is_hit(*compute_registration_error(
        gt, out["estimated_transform"]))


def learned_backend(device: str):
    """``reg_model.backend: learned`` through build_backend, on ``device``."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.reg.backend import build_backend

    cfg = make_cfg(model_name="sgaligner", modules=["point"])
    cfg.reg_model.backend = "learned"
    return build_backend(cfg, device=device)


def downstream_cfg(root: str):
    """scripts/downstream_quality.py's config: the full snapshot's tester
    config with registration by the learned backend."""
    from sgaligner_tpu_torch.core.config import make_cfg

    values = quality_cfg(root, snapshot_quality("full")["modules"])
    values["registration"] = True
    values["reg_model"] = {"backend": "learned"}
    return make_cfg(**values)


def downstream_run(root: str, device: str, max_scans: int) -> dict:
    """The two CLIs (their run functions: the card has no PyYAML) over the
    workspace at ``root`` on ``device``: the tables, each run's launch
    counts and seconds, and the first PointNet forward's inputs."""
    from sgaligner_tpu_torch.cli import inference_find_overlapper, inference_mosaicking
    from sgaligner_tpu_torch.models import pointnet
    from sgaligner_tpu_torch.ops import _build

    cfg = downstream_cfg(root)
    first, fwd = [], pointnet.pointnet_fwd

    def kept(*args, **kw):
        if not first:
            first.append(tuple(a.clone() for a in args))
        return fwd(*args, **kw)

    out = {"launches": {}, "s": {}}
    pointnet.pointnet_fwd = kept
    try:
        for task, run, kw in (("overlap", inference_find_overlapper.run, {}),
                              ("mosaicking", inference_mosaicking.run,
                               {"max_scans": max_scans})):
            _build.reset_launches()
            t0 = time.perf_counter()
            out[task] = run(cfg, device, snapshot=torch_snapshot("full"), **kw)
            out["s"][task] = time.perf_counter() - t0
            out["launches"][task] = dict(_build.LAUNCHES)
    finally:
        pointnet.pointnet_fwd = fwd
    out["first"] = first[0] if first else None
    return out


def _downstream_tables(tag: str, run: dict, state: dict) -> str:
    lines = [f"[downstream] {tag}: overlap ({run['s']['overlap']:.1f} s, pointnet_fwd "
             f"{run['launches']['overlap']['pointnet_fwd']} launches) "
             + "; ".join(f"{k} P {m['precision']:.4f} R {m['recall']:.4f} F1 "
                         f"{m['f1_score']:.4f}" for k, m in run["overlap"].items())]
    lines.append(f"[downstream] {tag}: mosaicking ({run['s']['mosaicking']:.1f} s, "
                 f"pointnet_fwd {run['launches']['mosaicking']['pointnet_fwd']} launches) "
                 + "; ".join(f"{k} " + ", ".join(f"{n} {v:.4f}" for n, v in m.items())
                             for k, m in run["mosaicking"].items()))
    return "\n".join(f"{line} | {state['card']}" for line in lines)


def _downstream_expected(root: str, max_scans: int) -> dict:
    """The PointNet forward launches each CLI makes: one an eval batch of 8
    pairs (overlap), one a subscan registered onto its scan's first
    (mosaicking); no other kernel."""
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.utils.io import load_json

    n_pairs = len(get_val_dataloader(downstream_cfg(root)).dataset)
    scans = load_json(str(Path(root) / "files" / "orig" / "scan_subscan_map_val.json"))
    subscans = sum(max(len(v) - 1, 0) for v in list(scans.values())[:max_scans])
    return {"overlap": -(-n_pairs // 8), "mosaicking": subscans}


def _check_downstream_launches(tag: str, root: str, run: dict, max_scans: int) -> None:
    want = _downstream_expected(root, max_scans)
    for task, n in want.items():
        expected = {k: (n if k == "pointnet_fwd" else 0) for k in (*KERNELS, *WIDE)}
        if run["launches"][task] != expected:
            raise AssertionError(f"downstream {tag} {task}: launches "
                                 f"{run['launches'][task]}, expected pointnet_fwd {n} "
                                 "and no other")


def ransac_repeat_check(state: dict) -> None:
    """``ransac_hypotheses_batch`` on the card and on the CPU over sets
    that repeat points: the same scores, the transforms within
    RANSAC_REPEAT_TF_ABS, and the degenerate minimal sets (a repeated
    point) the identity on both."""
    import numpy as np
    import torch

    from sgaligner_tpu_torch.reg.ransac import ransac_hypotheses_batch

    c = RANSAC_REPEAT
    rng = np.random.default_rng(c["seed"])
    half = c["n"] // 2
    src = rng.uniform(-1, 1, size=(c["sets"], half, 3))
    src = np.concatenate([src, src[:, rng.integers(0, half, size=half)]], axis=1)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rot *= np.linalg.det(rot)
    ref = src @ rot.T + 0.2 + rng.normal(0, 0.01, size=src.shape)
    ref[:, ::4] = rng.uniform(-1, 1, size=ref[:, ::4].shape)
    sides = {}
    for dev in ("cuda", "cpu"):
        tfs, scores = ransac_hypotheses_batch(
            torch.from_numpy(src).to(dev), torch.from_numpy(ref).to(dev),
            torch.ones(src.shape[:2], dtype=torch.bool, device=dev), c["seed"],
            list(range(c["sets"])), [0] * c["sets"],
            torch.full((c["sets"],), c["threshold"], dtype=torch.float64), iters=c["iters"])
        sides[dev] = (tfs.cpu(), scores.cpu())
    eye = torch.eye(4, dtype=torch.float64)
    degenerate = [torch.all(tfs == eye, dim=(-1, -2)) for tfs, _ in sides.values()]
    d = float((sides["cuda"][0] - sides["cpu"][0]).abs().max())
    if not (torch.equal(*degenerate) and torch.equal(sides["cuda"][1], sides["cpu"][1])
            and d <= RANSAC_REPEAT_TF_ABS and degenerate[0].any()):
        raise AssertionError(
            f"downstream: batched RANSAC over repeated points, card against CPU: "
            f"degenerate sets {int(degenerate[0].sum())} / {int(degenerate[1].sum())}, "
            f"scores equal {torch.equal(sides['cuda'][1], sides['cpu'][1])}, "
            f"transforms {d:.3e} apart (tolerance {RANSAC_REPEAT_TF_ABS})")
    log(f"[downstream] batched RANSAC over repeated points ({c['sets']} sets of {c['n']}, "
        f"{c['iters']} minimal sets each), card against CPU: "
        f"{int(degenerate[0].sum())} degenerate minimal sets identity on both, scores equal, "
        f"transforms at most {d:.3e} apart (tolerance {RANSAC_REPEAT_TF_ABS}) | {state['card']}")


def phase_downstream(state: dict) -> None:
    """The learned registration backend with the tracked geo_reg weights on
    the card, held to tests/test_learned_reg.py's floors and to the port's
    CPU path on the 0.4 band; then the JAX package's downstream contract
    (overlap detection and mosaicking of the full snapshot, the learned
    backend) through the port's two CLIs on the card, and on a cut of it
    the card's tables (the CPU's, from a child process started here, are
    held to them in phase_downstream_cpu)."""
    import tempfile

    import numpy as np

    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
    from sgaligner_tpu_torch.reg import eval_geo
    from sgaligner_tpu_torch.reg.eval_geo import is_hit
    from sgaligner_tpu_torch.reg.metrics import compute_registration_error
    from sgaligner_tpu_torch.reg.synthetic_pairs import make_pair

    card = state["card"]
    # the cut's CPU half, in a child process while the card runs on
    q = snapshot_quality("full")
    cut = tempfile.mkdtemp(prefix="sga_downstream_cut_")
    state["downstream_cut"] = cut
    make_synthetic_workspace(cut, split="val", n_pairs=DOWNSTREAM_CPU["pairs"],
                             n_nonoverlap_pairs=DOWNSTREAM_CPU["pairs"], seed=q["val_seed"],
                             **q["bench"])
    state["downstream_cpu"] = start_downstream_cpu(cut)
    be = learned_backend("cuda")

    # (a) full SO(3), tests/test_learned_reg.py:95-112
    rng = np.random.default_rng(GEO_SO3["seed"])
    hits, t0 = 0, time.perf_counter()
    for _ in range(GEO_SO3["pairs"]):
        src, ref, gt = make_pair(rng, n_points=GEO_SO3["n_points"], overlap=GEO_SO3["overlap"])
        out = be.register(src, ref)
        if out is None:
            raise AssertionError("downstream: the learned backend declined a full-SO(3) pair")
        rre, rte = compute_registration_error(gt, out["estimated_transform"])
        hits += is_hit(rre, rte)
        log(f"[downstream] SO(3) pair: RRE {rre:.3f} deg, RTE {rte:.4f} m, fit "
            f"{out['fit_score']:.3f}, {len(out['corr_scores'])} corrs")
    log(f"[downstream] SO(3): {hits}/{GEO_SO3['pairs']} hits (floor {GEO_SO3['min_hits']}) in "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    if hits < GEO_SO3["min_hits"]:
        raise AssertionError(f"downstream: {hits} full-SO(3) hits, floor {GEO_SO3['min_hits']}")

    # the low-overlap bands and the planar scenes, :149-187
    readings = {}
    for what, kw in (("bands", GEO_BANDS), ("planar", GEO_PLANAR)):
        t0 = time.perf_counter()
        res = eval_geo.evaluate(be, verbose=False, **kw)
        for ov, m in res.items():
            log(f"[downstream] {what} overlap {ov}: hits {m['hits']}/{m['n']}, RR {m['RR']:.3f}, "
                f"FMR {m['FMR']:.3f}, fails {m['fails']}, RRE {m['RRE']:.3f} deg, RTE "
                f"{m['RTE']:.4f} m (hits only {m['RRE_hit']:.3f} deg, {m['RTE_hit']:.4f} m), "
                f"CD {m['CD']:.5f}, corrs {m['n_corrs']:.0f} | {card}")
        log(f"[downstream] {what}: {time.perf_counter() - t0:.1f} s | {card}")
        readings[what] = res
    bands, planar = readings["bands"], readings["planar"][0.3]
    f = GEO_BAND_FLOORS
    checks = {f"hits at 0.3 + 0.4 >= {f['hits_mid']}":
              bands[0.3]["hits"] + bands[0.4]["hits"] >= f["hits_mid"],
              f"RR >= {f['rr']} at 0.3 and 0.4": min(bands[0.3]["RR"], bands[0.4]["RR"]) >= f["rr"],
              f"RTE of the hits <= {f['rte_hit']} at 0.4": bands[0.4]["RTE_hit"] <= f["rte_hit"],
              f"hits at 0.2 >= {f['hits_low']}": bands[0.2]["hits"] >= f["hits_low"],
              f"planar hits >= {GEO_PLANAR_HITS}": planar["hits"] >= GEO_PLANAR_HITS}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"downstream: the learned backend misses {failed}")
    log("[downstream] the learned backend meets every floor: " + ", ".join(checks))
    state["geo_bands"], state["geo_planar"] = bands, planar

    # the card against the CPU on the 0.4 band, the same draws; stage times
    quads = eval_geo.band_pairs(0.4, GEO_BANDS["n_pairs"], GEO_BANDS["seed"])
    pairs = [(q[0], q[1]) for q in quads]
    outs, secs = {}, {}
    for dev, backend in (("cuda", be), ("cpu", learned_backend("cpu"))):
        backend.profile_stages, backend._stage_times = True, {}
        t0 = time.perf_counter()
        outs[dev] = backend.register_batch(pairs)
        secs[dev] = time.perf_counter() - t0
        n = len(pairs)
        log(f"[downstream] register_batch of the 0.4 band on {dev}: {secs[dev] / n * 1e3:.1f} ms a "
            f"pair; stages, ms a pair: " + ", ".join(
                f"{k} {v / n * 1e3:.2f}" for k, v in backend._stage_times.items()) + f" | {card}")
    worst = 0.0
    for i, ((_, _, gt, _), c, h) in enumerate(zip(quads, outs["cuda"], outs["cpu"])):
        hit = [registered_hit(c, gt), registered_hit(h, gt)]
        if hit[0] != hit[1]:
            raise AssertionError(f"downstream: 0.4 band pair {i} hits on one side only "
                                 f"(card {hit[0]}, CPU {hit[1]})")
        if all(hit):
            d = float(np.abs(c["estimated_transform"] - h["estimated_transform"]).max())
            worst = max(worst, d)
            if not d <= GEO_TF_ABS:
                raise AssertionError(f"downstream: 0.4 band pair {i}: card and CPU transforms "
                                     f"{d:.3e} apart (> {GEO_TF_ABS})")
    log(f"[downstream] 0.4 band, card against CPU: the same hits, transforms at most "
        f"{worst:.3e} apart (tolerance {GEO_TF_ABS}); {secs['cuda']:.1f} s against "
        f"{secs['cpu']:.1f} s | {card}")
    state["geo_ms_pair"] = secs["cuda"] / len(pairs) * 1e3
    ransac_repeat_check(state)

    # (b) the downstream contract through the two CLIs
    launches = 0
    with tempfile.TemporaryDirectory(prefix="sga_downstream_") as tmp:
        full = str(Path(tmp) / "full")
        make_synthetic_workspace(full, split="val", n_pairs=q["n_val_pairs"],
                                 n_nonoverlap_pairs=q["n_val_pairs"], seed=q["val_seed"],
                                 **q["bench"])
        run = downstream_run(full, "cuda", DOWNSTREAM_MAX_SCANS)
        log(_downstream_tables(f"full contract ({q['n_val_pairs']} + {q['n_val_pairs']} "
                               f"pairs, {DOWNSTREAM_MAX_SCANS} scans), card", run, state))
        _check_downstream_launches("full contract", full, run, DOWNSTREAM_MAX_SCANS)
        launches += sum(r["pointnet_fwd"] for r in run["launches"].values())
        args = run["first"]
        err_abs, err_rel = check_op("pointnet_fwd", args, "f32",
                                    what="downstream pointnet_fwd/C3=256/f32")
        log(f"[downstream] the first request's pointnet_fwd again (O={args[0].shape[0]}, "
            f"P={args[0].shape[2]}, f32): max_abs {err_abs:.3e} max_rel {err_rel:.3e} "
            f"(tol {tol('pointnet_fwd', 'f32'):g})")
        state["downstream"] = run

    card_cut = downstream_run(cut, "cuda", DOWNSTREAM_CPU["scans"])
    log(_downstream_tables(f"cut ({DOWNSTREAM_CPU['pairs']} + {DOWNSTREAM_CPU['pairs']} pairs, "
                           f"{DOWNSTREAM_CPU['scans']} scans), cuda", card_cut, state))
    _check_downstream_launches("cut", cut, card_cut, DOWNSTREAM_CPU["scans"])
    launches += sum(r["pointnet_fwd"] for r in card_cut["launches"].values())
    state["downstream_cut_card"] = {k: card_cut[k] for k in ("overlap", "mosaicking")}
    state["launches_downstream"] = launches


def start_downstream_cpu(root: str) -> subprocess.Popen:
    """The downstream cut's CPU half (downstream_run on the CPU) in a child
    process of this script with no card, writing its tables to
    <root>/cpu_tables.json and its output to <root>/cpu.log."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(Path(root) / "cpu.log", "w") as out:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--downstream-cpu", root,
             str(DOWNSTREAM_CPU["scans"])], stdout=out, stderr=subprocess.STDOUT, env=env,
            cwd=str(REPO))


def downstream_cpu_main(root: str, scans: int) -> int:
    """--downstream-cpu: downstream_run on the CPU over the workspace at
    ``root``, its tables and seconds to <root>/cpu_tables.json."""
    sys.path.insert(0, str(REPO))
    run = downstream_run(root, "cpu", scans)
    with open(Path(root) / "cpu_tables.json", "w") as f:
        json.dump({k: run[k] for k in ("overlap", "mosaicking", "launches", "s")}, f,
                  default=float)
    return 0


def stop_downstream_cpu(state: dict) -> None:
    """Stop the downstream cut's child if it still runs and remove its
    workspace."""
    import shutil

    proc = state.pop("downstream_cpu", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    cut = state.pop("downstream_cut", None)
    if cut:
        shutil.rmtree(cut, ignore_errors=True)


def phase_downstream_cpu(state: dict) -> None:
    """The downstream cut's CPU tables (the child process) against the
    card's, within tests/test_downstream_quality.py's tolerances."""
    proc, cut = state["downstream_cpu"], state["downstream_cut"]
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        rc = None
    waited = time.perf_counter() - t0
    tail = (Path(cut) / "cpu.log").read_text(errors="replace")[-4000:]
    if rc != 0:
        stop_downstream_cpu(state)
        raise AssertionError(f"downstream_cpu: the CPU's child process "
                             f"{'ran past 900 s' if rc is None else f'exited {rc}'}:\n{tail}")
    with open(Path(cut) / "cpu_tables.json") as f:
        cpu = json.load(f)
    stop_downstream_cpu(state)
    log(_downstream_tables(f"cut ({DOWNSTREAM_CPU['pairs']} + {DOWNSTREAM_CPU['pairs']} pairs, "
                           f"{DOWNSTREAM_CPU['scans']} scans), cpu (child process; waited "
                           f"{waited:.1f} s for it here)", cpu, state))
    card = state["downstream_cut_card"]
    off = {}
    for key, m in cpu["overlap"].items():
        for k, v in m.items():
            if not abs(card["overlap"][key][k] - v) <= DOWNSTREAM_PRF_ABS:
                off[f"{key}.{k}"] = (card["overlap"][key][k], v)
    for key, m in cpu["mosaicking"].items():
        for k, v in m.items():
            limit = DOWNSTREAM_DIST_ABS if k in ("acc", "comp") else DOWNSTREAM_RATE_ABS
            if not abs(card["mosaicking"][key][k] - v) <= limit:
                off[f"{key}.{k}"] = (card["mosaicking"][key][k], v)
    if off:
        raise AssertionError(f"downstream: card against CPU beyond the tolerances: {off}")
    log("[downstream_cpu] the cut's tables, card against CPU: within P/R/F1 "
        f"{DOWNSTREAM_PRF_ABS}, acc/comp {DOWNSTREAM_DIST_ABS} m, prec/recall/fscore "
        f"{DOWNSTREAM_RATE_ABS}")


def build_train_workspace(root: str) -> None:
    """aligner_artifact.py's benchmark workspace: the train split
    (TRAIN_SEED, N_TRAIN_PAIRS pairs), then the val split (VAL_SEED,
    N_VAL_PAIRS) under the same root. The fixtures name scans by pair index,
    so the val split's files replace those of train pairs 0-31: the
    artifact's training saw the val pairs' scans, and so does the retrain."""
    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace

    make_synthetic_workspace(root, split="train", n_pairs=N_TRAIN_PAIRS,
                             seed=TRAIN_SEED, **BENCH)
    make_synthetic_workspace(root, split="val", n_pairs=N_VAL_PAIRS,
                             seed=VAL_SEED, **BENCH)


def train_cfg(root: str, out: str, modules, model_name: str = "sgaligner",
              epochs: int = MAX_EPOCH, dtype: str = "float32", bucket: int = 0):
    """The artifact's training config (quality_cfg's values: Adam at a flat
    1e-3, batch 8, the tester's layout) for ``epochs`` epochs, with its
    output tree under ``out``."""
    from sgaligner_tpu_torch.core.config import make_cfg, make_output_tree

    values = quality_cfg(root, modules, model_name)
    values["optim"]["max_epoch"] = epochs
    values["tpu"].update(compute_dtype=dtype, pooled_bucket=bucket)
    return make_output_tree(make_cfg(**values), out)


def retrain(cfg, halves: tuple[int, ...], device: str = "cuda") -> dict:
    """``cfg`` trained through trainval_eva's ``train`` to ``halves[0]``
    epochs, then by a new Trainer resumed from the rolling snapshot to each
    later entry; then the port's tester on best_snapshot.pth.tar (else
    snapshot.pth.tar, the artifact script's rule) over the val split. The
    launch counts are set to 0 before each part and read after it. Returns
    the tester's results, and per part the seconds, the launches and the
    Trainer's history; the snapshot's iteration and path."""
    import torch

    from sgaligner_tpu_torch.cli.trainval_eva import train
    from sgaligner_tpu_torch.core.checkpoint import load_torch_snapshot
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.engine.tester import AlignRegTester
    from sgaligner_tpu_torch.ops import _build

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    run: dict = {"seconds": [], "launches": [], "history": []}

    def part(fn):
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        run["seconds"].append(time.perf_counter() - t0)
        run["launches"].append(dict(_build.LAUNCHES))
        return out

    for i, epochs in enumerate(halves):
        cfg.optim.max_epoch = epochs
        run["history"].append(part(lambda: train(cfg, device, resume=i > 0)))
    snaps = Path(cfg.snapshot_dir)
    best = snaps / "best_snapshot.pth.tar"
    run["snapshot"] = str(best if best.is_file() else snaps / "snapshot.pth.tar")
    run["iteration"] = load_torch_snapshot(str(snaps / "snapshot.pth.tar"))["iteration"]
    loader = get_val_dataloader(cfg)
    tester = AlignRegTester(cfg, loader.dataset, loader, snapshot=run["snapshot"],
                            device=device)
    run["results"] = part(tester.run)
    return run


def _step_ms(run: dict) -> float:
    """The Trainer's mean process time a step (``time/process``: the step
    and, every ``log_steps``, the read-back) over a run's epochs, ms."""
    return 1e3 * statistics.mean(e["train"]["time/process"] for e in run["history"])


def bare_step_ms(cfg, steps: int = 20) -> float:
    """make_train_step alone on the card, on the first batch of ``cfg``'s
    train loader moved there once, from fresh seeded weights: 3 warm-up
    steps, then ms a step over ``steps`` synchronised steps (the Trainer's
    step without its loader, to_device, read-backs and snapshots)."""
    import torch

    from sgaligner_tpu_torch.data.batch import to_device
    from sgaligner_tpu_torch.data.loaders import get_train_val_data_loader
    from sgaligner_tpu_torch.engine.factory import build_model, build_objective
    from sgaligner_tpu_torch.engine.train_step import create_train_state, make_train_step

    train_loader, _ = get_train_val_data_loader(cfg)
    batch = to_device(next(iter(train_loader)), "cuda")
    train = create_train_state(build_model(cfg, "cuda"), cfg, build_objective(cfg))
    step = make_train_step(tuple(cfg.modules))
    for _ in range(3):
        step(train, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(train, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_trainer(state: dict) -> None:
    """The EVA recipe retrained on the card through the port's Trainer
    (resumed halfway) and held to RETRAIN_FLOORS by the port's tester; then
    the pct configuration for PCT_TRAIN_EPOCHS epochs through the same
    Trainer, its launches held to the per-step and per-request counts and
    its final snapshot read back by the tester."""
    import math
    import tempfile

    steps_per_epoch = N_TRAIN_PAIRS // 8
    val_batches = -(-N_VAL_PAIRS // 8)
    with tempfile.TemporaryDirectory(prefix="sga_trainer_") as tmp:
        ws = str(Path(tmp) / "ws")
        t0 = time.perf_counter()
        build_train_workspace(ws)
        log(f"[trainer] workspace ({N_TRAIN_PAIRS} train pairs, seed {TRAIN_SEED}; "
            f"{N_VAL_PAIRS} val pairs, seed {VAL_SEED}) built in "
            f"{time.perf_counter() - t0:.1f} s")

        cfg = train_cfg(ws, str(Path(tmp) / "eva"), EVA_RECIPE["modules"], "eva")
        run = retrain(cfg, (RETRAIN_HALF, EVA_RECIPE["epochs"]))
        steps = steps_per_epoch * EVA_RECIPE["epochs"]
        if run["iteration"] != steps:
            raise AssertionError(f"trainer eva: the rolling snapshot is at step "
                                 f"{run['iteration']}, expected {steps}")
        fwd = sum(la["pointnet_fwd"] for la in run["launches"][:2])
        bwd = sum(la["pointnet_bwd"] for la in run["launches"][:2])
        want_fwd = steps + EVA_RECIPE["epochs"] * val_batches
        if (fwd, bwd) != (want_fwd, steps):
            raise AssertionError(f"trainer eva: pointnet_fwd / pointnet_bwd launched "
                                 f"{fwd} / {bwd} times, expected {want_fwd} / {steps}")
        if any(v for la in run["launches"] for k, v in la.items() if k not in POINT_KERNELS):
            raise AssertionError(f"trainer eva: a kernel off the EVA path ran: {run['launches']}")
        got = run["results"]
        low = {k: got[k] for k, floor in RETRAIN_FLOORS.items() if not got[k] >= floor}
        for i, (secs, hist) in enumerate(zip(run["seconds"], run["history"])):
            n = steps_per_epoch * len(hist["history"])
            log(f"[trainer] eva half {i + 1}: {len(hist['history'])} epochs, {n} steps in "
                f"{secs:.1f} s ({secs / n * 1e3:.2f} ms a step with the val passes, "
                f"snapshots and loading; the Trainer's process time {_step_ms(hist):.2f} ms "
                f"a step); last train loss {hist['history'][-1]['train']['loss']:.4f}, "
                f"val loss {hist['history'][-1]['val']['loss']:.4f} | {state['card']}")
        log(f"[trainer] eva retrain ({EVA_RECIPE['epochs']} epochs, {steps} steps, resumed "
            f"at epoch {RETRAIN_HALF}) through the tester on {Path(run['snapshot']).name}: "
            + ", ".join(f"{k} {got[k]:.4f}" for k in (*QUALITY_KEYS, "sgar@2", "sgar@50",
                                                       "sgar@100"))
            + f" (floors {RETRAIN_FLOORS}; the tracked EVA reads "
            f"{snapshot_quality('eva')['results']['mrr']:.4f} / "
            f"{snapshot_quality('eva')['results']['hits@1']:.4f}); pointnet_fwd {fwd} "
            f"launches ({steps} steps + {EVA_RECIPE['epochs']} val passes of {val_batches}), "
            f"pointnet_bwd {bwd}, C3 = {EVA_C3} | {state['card']}")
        if low:
            raise AssertionError(f"trainer eva: {low} below the floors {RETRAIN_FLOORS}")
        state["launches_trainer_eva"] = bwd
        state["launches_trainer_eva_fwd"] = fwd
        state["trainer_eva_ms"] = [_step_ms(h) for h in run["history"]]
        log(f"[trainer] eva: the bare train step on one of its batches "
            f"{bare_step_ms(cfg):.2f} ms a step against the Trainer's process time "
            + " / ".join(f"{ms:.2f}" for ms in state["trainer_eva_ms"])
            + f" ms (f32, O={EVA_TRAIN_O}) | {state['card']}")

        cfg = train_cfg(ws, str(Path(tmp) / "pct"), MODULES, epochs=PCT_TRAIN_EPOCHS,
                        dtype="bfloat16", bucket=QUALITY_BUCKET)
        run = retrain(cfg, (PCT_TRAIN_EPOCHS,))
        steps = steps_per_epoch * PCT_TRAIN_EPOCHS
        want = {k: steps * PER_PCT_TRAIN_STEP.get(k, 0)
                + PCT_TRAIN_EPOCHS * val_batches * PER_REQUEST.get(k, 0)
                for k in (*KERNELS, *WIDE)}
        if run["launches"][0] != want:
            raise AssertionError(f"trainer pct: launches {run['launches'][0]}, "
                                 f"expected {want}")
        _check_launches("trainer pct tester", run["launches"][1], PER_REQUEST, val_batches)
        hist = run["history"][0]["history"]
        losses = [e["train"]["loss"] for e in hist] + [e["val"]["loss"] for e in hist]
        if not all(math.isfinite(v) for v in losses) or run["iteration"] != steps:
            raise AssertionError(f"trainer pct: losses {losses}, step {run['iteration']} "
                                 f"of {steps}")
        got = run["results"]
        log(f"[trainer] pct config (bf16, pooled {QUALITY_BUCKET}) {PCT_TRAIN_EPOCHS} epochs, "
            f"{steps} steps in {run['seconds'][0]:.1f} s (the Trainer's process time "
            f"{_step_ms(run['history'][0]):.2f} ms a step; the bare step on one of its "
            f"batches {bare_step_ms(cfg):.2f} ms; bench.py's B={TRAIN_B} step "
            f"{state['train_pct_ms']:.2f} ms at O={state['train_pct_o']}); train loss "
            + " -> ".join(f"{e['train']['loss']:.4f}" for e in hist)
            + f"; the tester on {Path(run['snapshot']).name}: mrr {got['mrr']:.4f}, "
            f"hits@1 {got['hits@1']:.4f}; launches {run['launches'][0]} | {state['card']}")


# phase dp: data parallel (sgaligner_tpu_torch/parallel/mesh.py), DP ranks
# started by parallel.launch.run_ranks: NCCL, one card a rank, where the
# machine has DP cards, else gloo with the ranks sharing card 0. Every run is
# held to one rank on the same per-rank pooled layout
# (pool_compact_sharded(dp=DP)). Training: three f32 Adam steps of the pct
# configuration at B = 32 (16 a rank) of train_pct_parity's generator. Each
# reading (worst gradient leaf, losses, parameters against the distance
# moved, BN running statistics) is held to the larger of two rounding
# references, each times its own factor: DP_VS_CPU times the CPU's own f32
# dp = DP against dp = 1 reading on the batch's first DP_CPU_B pairs (as §2
# of PERF.md derives the 20x rule), and DP_VS_REORDER times the card's own
# one-rank reading with the same batch pooled in the one-rank order
# (pool_compact): the card's f32 kernels add their sums in sequential
# slices, and re-associating them alone moves the readings several to tens
# of times as far as the CPU's (PERF.md §6), so that reading is the card's
# noise floor, and a small multiple of it keeps the bound tight. The
# parameters' bound must stay below DP_PARAM_MAX of the distance they moved:
# at or past that distance the reading could catch nothing. Every run takes the tail argmax /
# argmin of the card's (the CPU's) dp = 1 run (tail_indices), and DP_FLOOR
# is the least bound. Then the same steps with one block's sums left local
# (sa1's forward, DP_PLANTED), which a reading must catch, and the ranks'
# parameters and running statistics held to the same bits. Serving:
# one bf16 B = 512 request split over the ranks against the one-rank request
# (counts exact; rr_sum and alignment_score within DP_SERVE_RTOL: the eval
# kernels compute each object alone). Timing: ms a bf16 step and a request at
# dp = DP and dp = 1, readings
DP = 2
DP_STEPS = 3
DP_CPU_B = 4
DP_VS_CPU = PCT_VS_CPU
DP_VS_REORDER = 5.0
DP_PARAM_MAX = 0.5
DP_FLOOR = 1e-6
DP_SERVE_RTOL = 1e-6
DP_TIME_STEPS = 10
DP_TIME_REQUESTS = 4
DP_TIMEOUT = 400.0
DP_PLANTED = "sa1's forward sums left local"


def _dp_hosts() -> dict:
    """The phase's host batches, each pooled per rank's block: the parity
    batch (B = 32 of train_pct_parity's generator; its first DP_CPU_B pairs
    are the CPU's batch), bench.py's training batch and serve's first
    request."""
    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact_sharded
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch

    def parity(b, dp=DP):
        return pool_compact_sharded(make_synthetic_batch(
            BatchSpec(b, 32, P), seed=3, bow_noise=1.0, resample=True), 128, dp)

    return {"train": parity(TRAIN_B), "cpu": parity(DP_CPU_B),
            "train_one_rank": parity(TRAIN_B, 1),
            "bench": pool_compact_sharded(make_synthetic_batch(
                BatchSpec(TRAIN_B, 32, P), seed=0), 128, DP),
            "serve": pool_compact_sharded(make_synthetic_batch(
                BatchSpec(512, 32, P), seed=100), 128, DP)}


def _dp_train(host, dev: str, mesh=None, replay=None, planted: bool = False) -> dict:
    """``_train_three`` of the pct configuration at f32 on this rank's block
    (``mesh``; one rank without), recording the tail's argmax / argmin of
    each step; with ``replay`` the tail takes those of the one-rank run
    (this rank's rows); ``planted``: sa1's forward sums are left local.
    Also the launches of the run."""
    from sgaligner_tpu_torch.ops import _build, pct_attention

    picks: list = []
    o = host["obj_points_pooled"].shape[0]
    rows = mesh.block(o // mesh.dp) if mesh is not None else slice(None)
    reduce_sum, calls = pct_attention.reduce_sum, [0]

    def leave_first(m, tensors):
        # BlockResidual sums twice a step and block: sa1..sa4 forward, then
        # sa4..sa1 backward; the first of each eight is sa1's forward
        calls[0] += 1
        return list(tensors) if calls[0] % 8 == 1 else reduce_sum(m, tensors)

    if planted:
        pct_attention.reduce_sum = leave_first
    _build.reset_launches()
    try:
        with tail_indices(picks, replay, rows):
            run = _train_three(_cfg("float32", 32, MODULES), host, dev, MODULES, mesh)
    finally:
        pct_attention.reduce_sum = reduce_sum
    run["launches"] = dict(_build.LAUNCHES)
    run["picks"] = picks
    return run


def _dp_times(hosts: dict, dev: str, mesh=None) -> dict:
    """On this rank (its block under ``mesh``): bf16 train steps of the pct
    configuration (B = 32, bench.py's settings) and B = 512 requests, ms
    each (host clock, synchronised; the ranks start each window together),
    the launches of each window, and the first request's outputs."""
    import torch

    from sgaligner_tpu_torch.data.batch import to_device
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import (create_train_state,
                                                       make_serving_step, make_train_step)
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.parallel.mesh import barrier, shard_batch

    cfg = _cfg("bfloat16", 32)
    cfg.model.dropout = 0.0
    train = create_train_state(build_model(cfg, dev, torch.Generator().manual_seed(0)), cfg)
    step = make_train_step(MODULES, mesh)
    batch = to_device(shard_batch(hosts["bench"], mesh), dev)
    for _ in range(WARMUP_STEPS):
        step(train, batch)
    barrier(mesh, dev)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(DP_TIME_STEPS):
        out = step(train, batch)
    torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) / DP_TIME_STEPS * 1e3
    train_launches = dict(_build.LAUNCHES)
    loss = float(out["loss"])

    serve = make_serving_step(build_model(cfg, dev, torch.Generator().manual_seed(0)),
                              MODULES, mesh=mesh)
    request = to_device(shard_batch(hosts["serve"], mesh), dev)
    first = serve(request)
    first = {k: (tuple(int(t) for t in v) if isinstance(v, tuple) else v.cpu())
             for k, v in first.items()}
    barrier(mesh, dev)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    times = []
    for _ in range(DP_TIME_REQUESTS):
        t0 = time.perf_counter()
        serve(request)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": step_ms, "loss": loss, "train_launches": train_launches,
            "request_ms": statistics.median(times), "requests": times,
            "serve_launches": dict(_build.LAUNCHES), "first": first}


def _relayout(picks: list, src: dict, dst: dict) -> list:
    """Tail picks of a run on ``src``'s pooled rows placed on ``dst``'s:
    both pool the same objects in batch order, padded apart."""
    import torch

    a = torch.as_tensor(src["pooled_mask"])
    b = torch.as_tensor(dst["pooled_mask"])
    out = []
    for pair in picks:
        moved = []
        for t in pair:
            m = torch.zeros((b.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype)
            m[b] = t[a]
            moved.append(m)
        out.append(tuple(moved))
    return out


def _wait_for(path: Path, timeout: float) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"dp: {path.name} did not appear in {timeout:g} s")
        time.sleep(0.2)


def _save(obj, path: Path) -> None:
    import torch

    torch.save(obj, path.with_suffix(".part"))
    path.with_suffix(".part").replace(path)


def dp_rank(mesh, work: str, backend: str) -> None:
    """One rank of phase dp (``parallel.launch.run_ranks`` starts it): the
    card's f32 parity steps (replaying the one-rank tail picks), the planted
    run, then, once the one-rank CPU run has written its picks, the CPU's
    f32 dp = DP steps (over gloo), then the timings. Writes
    ``rank<r>.pt``."""
    import os

    import torch
    import torch.distributed as dist

    from sgaligner_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = f"cuda:{mesh.rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(dev)
    cpu_mesh = (mesh if backend == "gloo"
                else Mesh(mesh.dp, mesh.rank, dist.new_group(backend="gloo")))
    work = Path(work)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    hosts = inp["hosts"]
    out = {"card": _dp_train(hosts["train"], dev, mesh, inp["picks"]),
           "planted": _dp_train(hosts["train"], dev, mesh, inp["picks"], planted=True)}
    _wait_for(work / "cpu.pt", DP_TIMEOUT)
    cpu_picks = torch.load(work / "cpu.pt", weights_only=False)
    torch.set_num_threads(max(1, (os.cpu_count() or DP) // DP))
    out["cpu"] = _dp_train(hosts["cpu"], "cpu", cpu_mesh, cpu_picks)
    out["times"] = _dp_times(hosts, dev, mesh)
    out["device"] = dev
    _save(out, work / f"rank{mesh.rank}.pt")


def _picks_apart(run: dict, replay: list, rows: slice) -> tuple[int, int]:
    """(argmax / argmin entries this rank's tail picked apart from the
    replayed ones, entries) at step 1."""
    (amax, amin), (rmax, rmin) = run["picks"][0], replay[0]
    return (int((amax != rmax[rows]).sum()) + int((amin != rmin[rows]).sum()),
            2 * amax.numel())


def phase_dp(state: dict) -> None:
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sgaligner_tpu_torch.parallel.launch import run_ranks

    card = state["card"]
    backend = "nccl" if torch.cuda.device_count() >= DP else "gloo"
    where = (f"{DP} cards, one a rank" if backend == "nccl"
             else f"one card that the {DP} ranks share")
    log(f"[dp] {DP} ranks over {backend} on {where}")
    hosts = _dp_hosts()
    o_train = hosts["train"]["obj_points_pooled"].shape[0]
    o_cpu = hosts["cpu"]["obj_points_pooled"].shape[0]

    # one rank first (the card to itself): the f32 parity run, recording its
    # tail picks, then the timings
    t0 = time.perf_counter()
    one = _dp_train(hosts["train"], "cuda")
    _check_launches("dp: one rank, f32 steps", one["launches"], PER_PCT_TRAIN_STEP, DP_STEPS)
    reorder = _dp_train(hosts["train_one_rank"], "cuda", replay=_relayout(
        one["picks"], hosts["train"], hosts["train_one_rank"]))
    one_times = _dp_times(hosts, "cuda")
    log(f"[dp] one rank: f32 steps and timings {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="sga_dp_") as tmp:
        work = Path(tmp)
        _save({"hosts": hosts, "picks": one["picks"]}, work / "inputs.pt")
        with ThreadPoolExecutor(1) as pool:
            t0 = time.perf_counter()
            ranks = pool.submit(run_ranks, dp_rank, DP, backend, str(work), backend,
                                timeout=DP_TIMEOUT)
            try:
                # the CPU's one-rank run beside the ranks' card runs
                one_cpu = _dp_train(hosts["cpu"], "cpu")
                _save(one_cpu["picks"], work / "cpu.pt")
            finally:
                ranks.result()
            log(f"[dp] the ranks and the one-rank CPU run {time.perf_counter() - t0:.1f} s")
        two = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DP)]

    failed = []
    rows_train = [slice(r * o_train // DP, (r + 1) * o_train // DP) for r in range(DP)]
    rows_cpu = [slice(r * o_cpu // DP, (r + 1) * o_cpu // DP) for r in range(DP)]
    for r, t in enumerate(two):
        for tag, run in (("card", t["card"]), ("planted", t["planted"])):
            _check_launches(f"dp: rank {r} {tag}, f32 steps", run["launches"],
                            PER_PCT_TRAIN_STEP, DP_STEPS)
    # training: the CPU's own dp = DP against dp = 1 distance and the card's
    # reordered one-rank distance set the bounds
    ref = _train_readings(one_cpu, two[0]["cpu"], {})
    rounding = _train_readings(one, reorder, {})
    bounds = {k: max(DP_VS_CPU * ref[k], DP_VS_REORDER * rounding[k], DP_FLOOR)
              for k in ("grad", "loss", "param", "stats")}
    got = _train_readings(one, two[0]["card"], bounds)
    planted = _train_readings(one, two[0]["planted"], bounds)
    apart = {tag: [_picks_apart(t[key], replay, rows[r]) for r, t in enumerate(two)]
             for tag, key, replay, rows in (("card", "card", one["picks"], rows_train),
                                            ("CPU", "cpu", one_cpu["picks"], rows_cpu))}
    for who, x in ((f"dp={DP} against dp=1, CPU, B={DP_CPU_B} (O={o_cpu})", ref),
                   (f"one rank, its rows in the other order, card, B={TRAIN_B}", rounding),
                   (f"dp={DP} against dp=1, card, B={TRAIN_B} (O={o_train})", got)):
        log(f"[dp] f32 {who}: worst gradient leaf {x['leaf']} "
            f"{x['grad']:.3e}; losses {x['loss']:.3e}; parameters {x['param']:.3e} (most in "
            f"{x['param_leaf']}); running statistics {x['stats']:.3e}")
    log(f"[dp] bounds (the larger of {DP_VS_CPU:g} x the CPU's and {DP_VS_REORDER:g} x the "
        f"card's reordered reading, at least {DP_FLOOR:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in bounds.items())
        + f"; the card's readings {', '.join(got['failed']) or 'all'} "
        + ("beyond them" if got["failed"] else "within them"))
    for tag, per_rank in apart.items():
        log(f"[dp] tail picks at step 1 apart from the one-rank run's, {tag}, per rank: "
            + ", ".join(f"{a} of {n}" for a, n in per_rank))
    total = sum(n for _, n in apart["card"])
    if got["failed"]:
        failed.append(f"training readings beyond their bounds: {got['failed']}")
    if bounds["param"] > DP_PARAM_MAX:
        failed.append(f"the parameters' bound {bounds['param']:.3e} of the distance moved "
                      f"exceeds {DP_PARAM_MAX:g}: the card's rounding is too loud to check them")
    if not sum(a for a, _ in apart["card"]) <= PCT_INDEX_APART * total:
        failed.append("tail picks apart")
    log(f"[dp] planted fault ({DP_PLANTED}): gradient {planted['leaf']} {planted['grad']:.3e}, "
        f"loss {planted['loss']:.3e}, parameters {planted['param']:.3e}, statistics "
        f"{planted['stats']:.3e}; caught by {planted['failed']}")
    if not planted["failed"]:
        failed.append("the planted fault went unseen")
    # the ranks' parameters and running statistics, bit for bit
    a, b = two[0]["card"]["params"], two[1]["card"]["params"]
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"[dp] rank 1's parameters and running statistics after {DP_STEPS} steps against "
        f"rank 0's: {len(a) - len(unequal)} of {len(a)} tensors bit-equal")
    if unequal:
        failed.append(f"ranks apart in {unequal[:5]}")

    # serving: the split request against the one-rank request
    want = one_times["first"]
    worst = {"rr_sum": 0.0, "alignment_score": 0.0}
    counts = [k for k in want if k == "rr_count" or k.startswith("hits@")]
    counts_apart = False
    for r, t in enumerate(two):
        first = t["times"]["first"]
        off = [k for k in counts if (first[k] != want[k] if isinstance(want[k], tuple)
                                     else int(first[k]) != int(want[k]))]
        if off:
            counts_apart = True
            failed.append(f"rank {r}'s request counts differ: {off}")
        for k in worst:
            w = want[k].double()
            d = float(((first[k].double() - w).abs() / w.abs().clamp_min(1e-30)).max())
            worst[k] = max(worst[k], d)
        _check_launches(f"dp: rank {r} requests", t["times"]["serve_launches"], PER_REQUEST,
                        DP_TIME_REQUESTS)
        _check_launches(f"dp: rank {r} bf16 steps", t["times"]["train_launches"],
                        PER_PCT_TRAIN_STEP, DP_TIME_STEPS)
    log(f"[dp] B=512 bf16 request split over {DP} ranks against one rank: counts "
        f"{'APART' if counts_apart else 'equal'}; rr_sum "
        f"{worst['rr_sum']:.3e}, alignment_score {worst['alignment_score']:.3e} relative "
        f"(bound {DP_SERVE_RTOL:g})")
    if max(worst.values()) > DP_SERVE_RTOL:
        failed.append(f"request metrics apart: {worst}")
    _check_launches("dp: one rank requests", one_times["serve_launches"], PER_REQUEST,
                    DP_TIME_REQUESTS)
    _check_launches("dp: one rank bf16 steps", one_times["train_launches"],
                    PER_PCT_TRAIN_STEP, DP_TIME_STEPS)

    shared = " (two ranks on one card: not a scaling figure)" if backend == "gloo" else ""
    log(f"[dp] bf16 step, B={TRAIN_B}: dp=1 {one_times['step_ms']:.2f} ms; dp={DP} "
        + " / ".join(f"{t['times']['step_ms']:.2f}" for t in two)
        + f" ms (rank by rank){shared} | {card}")
    log(f"[dp] bf16 request, B=512: dp=1 {one_times['request_ms']:.2f} ms; dp={DP} "
        + " / ".join(f"{t['times']['request_ms']:.2f}" for t in two) + f" ms (median of "
        f"{DP_TIME_REQUESTS}, rank by rank){shared} | {card}")
    for t in two:
        if not np.isfinite(t["times"]["loss"]):
            failed.append("a bf16 step's loss is not finite")
    state["dp"] = {"backend": backend, "readings": got, "bounds": bounds, "cpu": ref,
                   "rounding": rounding, "planted": planted, "serve": worst,
                   "one": one_times, "two": [t["times"] for t in two]}
    if failed:
        raise AssertionError(f"dp: {failed}")


def bwd_work(args) -> tuple[int, int, int]:
    """The gradient-carrying work of one pointnet_bwd call on its inputs:
    (rows, channels, tiles) summed over objects. A channel carries gradient
    when its max is positive and its cotangent non-zero, at its argmax point
    alone; rows counts the distinct points those channels pick (and those
    a NaN max marks), tiles the 64-row tiles they fill object by object."""
    import torch

    x, dout, amax, peak, *ws = args
    live = (peak > 0) & (dout != 0)
    hit = torch.zeros(x.shape[0], x.shape[-1], device=x.device)
    hit.scatter_add_(1, amax.long(), (live | peak.isnan()).float())
    per_obj = (hit > 0).sum(dim=1)
    return (int(per_obj.sum()), int(live.sum()), int(((per_obj + 63) // 64).sum()))


def block_flops(p: int = P, c: int = C) -> int:
    """Operations of one object's SA block forward: q, v, E = q qᵀ, y = G v,
    t = u Wt (122 MFLOP at P=512, C=128; 117 MFLOP at P=C=256)."""
    da = c // 4
    return 2 * p * c * (da + c) + 2 * p * p * da + 2 * p * p * c + 2 * p * c * c


def attn_flops(oa: bool = False, bwd: bool = False, p: int = P, c: int = C) -> int:
    """Operations of one object's attention op (row 10: q, v, E = q qᵀ,
    y = G v; 105 MFLOP at P=512, C = 128). Its backward (row 11): the
    projections and E again (and y for OA's c), dv = Gᵀ dŶ and dG = dŶ vᵀ,
    dq = (dE + dEᵀ) q, dWqk and dWv, dx = dq Wqkᵀ + dv Wvᵀ."""
    da = c // 4
    proj_e = 2 * p * c * (da + c) + 2 * p * p * da
    if not bwd:
        return proj_e + 2 * p * p * c
    return (proj_e + (2 * p * p * c if oa else 0) + 2 * 2 * p * p * c + 2 * 2 * p * p * da
            + 2 * 2 * p * c * (da + c))


def bound(name: str, o: int, p: int = P, work: tuple[int, int] | None = None,
          oa: bool = False, c3: int = PN[-1], f32: bool = False, c: int = C
          ) -> tuple[float, str]:
    """Least time (ms) for the work of one call at O objects, bf16, or
    with ``f32`` f32 at the f32 rate (the f32 forms use no tensor cores).
    pointnet_bwd counts only the work its data needs
    (``work`` from ``bwd_work``); ``oa``: the OA flags (the attention
    backward's y); ``c3``: the PointNet's real channels (padding is not
    work); ``c``: the block kernels' and the epilogue sums' channels (da =
    c / 4)."""
    da = c // 4
    e = 4 if f32 else 2  # bytes per element
    c1, c2 = PN[:2]
    w_elems = 3 * c1 + c1 + c1 * c2 + c2 + c2 * c3 + c3
    stack_flops = 2 * (3 * c1 + c1 * c2 + c2 * c3)          # per point
    if name == "pointnet_fwd":
        nbytes = o * 3 * p * e + w_elems * e + o * c3 * e + o * c3 * 4
        ops, rate = o * p * stack_flops, BF16_TENSOR_FLOPS
    elif name == "pointnet_bwd":
        # inputs x, dout, amax, weights; outputs f32 gradients. Operations:
        # at each picked row, h1 and h2 again, g1 = g2·w2ᵀ, dW2 and dW1;
        # for each live channel, its a3 at its row (the relu mask), its
        # column of dW3 and its share of g2 = g3·w3ᵀ
        rows, chans = work[:2]
        nbytes = o * 3 * p * e + o * c3 * (e + 4) + w_elems * e + w_elems * 4
        ops = (rows * 2 * (3 * c1 + c1 * c2 + 2 * c1 * c2 + 3 * c1)
               + chans * 3 * 2 * c2)
        rate = BF16_TENSOR_FLOPS
    elif name == "embed_first":
        nbytes = o * 3 * P * e + 3 * C * e + o * e + o * P * C * e + 2 * C * 4
        ops, rate = 2 * 3 * C * o * P, F32_FLOPS
    elif name == "embed_second":
        nbytes = 2 * o * P * C * e + C * C * e + 2 * C * e + o * e + 2 * C * 4
        ops, rate = 2 * o * P * C * C, BF16_TENSOR_FLOPS
    elif name in ("pct_block_eval", "pct_block_fwd"):
        # q, v, E = q qᵀ, y = G v, t = u Wt; x read, the output written
        nbytes = 2 * o * p * c * e + (c * da + 2 * c * c + 2 * c) * e + 2 * c * 4
        ops = o * block_flops(p, c)
        rate = BF16_TENSOR_FLOPS
    elif name in ("pct_block_res_bwd", "pct_block_bwd"):
        # the forward again; dWt and dY = dz Wtᵀ; dv = Gᵀ dY and dG = dY vᵀ;
        # dq = (dE + dEᵀ) q; dWqk, dWv and dx = dq Wqkᵀ + dv Wvᵀ. x and dxn (or
        # dt) read, dx written, f32 weight gradients
        back = (2 * 2 * p * c * c + 2 * 2 * p * p * c + 2 * 2 * p * p * da
                + 2 * 2 * p * c * da + 2 * 2 * p * c * c)
        vecs = 4 if name == "pct_block_res_bwd" else 2
        nbytes = (3 * o * p * c * e + (c * da + 2 * c * c + 2 * c) * e + o * e + vecs * c * 4
                  + (c * da + 2 * c * c + 2 * c) * 4)
        ops, rate = o * (block_flops(p, c) + back), BF16_TENSOR_FLOPS
    elif name == "pct_attn_fwd":
        # x read, y written
        nbytes = 2 * o * p * c * e + (c * da + c * c + c) * e
        ops, rate = o * attn_flops(p=p, c=c), BF16_TENSOR_FLOPS
    elif name == "pct_attn_bwd":
        # x and dy read, dx written, f32 weight gradients
        nbytes = 3 * o * p * c * e + (c * da + c * c + c) * (e + 4)
        ops, rate = o * attn_flops(oa, bwd=True, p=p, c=c), BF16_TENSOR_FLOPS
    elif name == "pct_epi_sums":
        nbytes = 2 * o * p * c * e + 2 * c * 4 + 2 * c * 4
        ops, rate = 4 * o * p * c, F32_FLOPS
    elif name == "embed_first_bwd":
        # h recomputed (3 FMAs), dz, dW (3 FMAs) per element; x and dh read
        nbytes = o * 3 * P * e + o * P * C * e + 3 * C * e + o * e + 2 * C * 4 + 3 * C * 4
        ops, rate = 2 * 2 * 3 * C * o * P, F32_FLOPS
    elif name == "embed_second_bwd":
        # h recomputed, dW1 and dx0: three [P, C] x [C, C] products per object;
        # h0 and dh read, dh0 written
        nbytes = 3 * o * P * C * e + C * C * e + 2 * C * e + o * e + 2 * C * 4 + (C * C + 2 * C) * 4
        ops, rate = 3 * 2 * o * P * C * C, BF16_TENSOR_FLOPS
    elif name == "pct_tail_bwd":
        # z recomputed, dx = g Wᵀ and dW = xᵀ g: three 2·P·512·K products per
        # object; x1..x4 read and dx1..dx4 written, W read, f32 dW written
        nbytes = (8 * o * P * C * e + 4 * C * K * e + o * e + 2 * o * K * (4 + 4) + 2 * K * 4
                  + 4 * C * K * 4)
        ops, rate = 3 * 2 * o * P * 4 * C * K, BF16_TENSOR_FLOPS
    else:
        nbytes = 4 * o * P * C * e + 4 * C * K * e + o * e + 2 * o * K * 4 + 2 * K * 4
        ops, rate = 2 * o * P * 4 * C * K, BF16_TENSOR_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / (F32_FLOPS if f32 else rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_time(state: dict) -> None:
    import torch

    o = state["serve_o"]
    chunk = 1024
    rows = []
    for name in PCT_KERNELS:
        source, replaces = KERNELS[name]
        kern, plain = op_fns(name)
        args = op_inputs(name, o, torch.bfloat16, seed=2)
        got = as_tuple(kern(*args))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(*args))
        # the plain version in object chunks (it materialises [O, P, P] or
        # [O, P, K] intermediates): per-object outputs are concatenated, the
        # [1, ·] sums added up
        plain_total, parts = 0.0, []
        for lo in range(0, o, chunk):
            sub = tuple(a[lo:lo + chunk] if i in PER_OBJECT_ARGS[name] else a
                        for i, a in enumerate(args))
            plain_total += cuda_ms(lambda: plain(*sub), warmup=1, reps=1)
            parts.append(as_tuple(plain(*sub)))
        want = [sum(outs[1:], outs[0]) if outs[0].shape[0] == 1 else torch.cat(outs)
                for outs in zip(*parts)]
        err_abs, err_rel = compare(tuple(got), tuple(want))
        tol = TOL[(name, "bf16")]
        if not err_rel <= tol:
            raise AssertionError(f"time: {name} at O={o} disagrees with the plain "
                                 f"version ({err_rel:.3e} > {tol:g})")
        library_ms = None
        if name == "pct_tail":
            cat_x = torch.cat(args[:4], dim=-1).reshape(o * P, 4 * C)
            library_ms = cuda_ms(lambda: torch.matmul(cat_x, args[4]))
            del cat_x
        b_ms, b_by = bound(name, o)
        if name in WMMA_MS:
            log(f"[time] {name} O={o} bf16: {ms:.3f} ms, {b_ms / ms:.1%} of its bound; the "
                f"WMMA design {WMMA_MS[name]} ms ({b_ms / WMMA_MS[name]:.1%}) | {state['card']}")
        if name == "pct_block_eval":
            split = pass_split(lambda: kern(*args), tuple(BLOCK_EVAL_PASSES.values()))
            log(f"[time] pct_block_eval O={o} passes (torch.profiler, ms a launch): " + ", ".join(
                f"{key} {split.get(kname, 0.0):.3f} (WMMA design {WMMA_SPLIT[key]})"
                for key, kname in BLOCK_EVAL_PASSES.items()) + f" | {state['card']}")
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": state["launches"][name],
               "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_total,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        log(f"[time] {name:15s} O={o} bf16 kernel {ms:.3f} ms | plain {plain_total:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by}) | library {library_ms} | max_abs {err_abs:.3e} "
            f"max_rel {err_rel:.3e} | {state['card']}")
        rows.append(row)
        del args, got, parts, want
        torch.cuda.empty_cache()
    per_req = sum(PER_REQUEST[r["name"]] * r["ms"] for r in rows)
    log(f"[time] the kernels at O={o} take {per_req:.1f} ms per request "
        f"({PER_REQUEST}); median request {state['serve_ms']:.1f} ms, so "
        f"{per_req / state['serve_ms']:.1%} of it | {state['card']}")
    rows += time_pointnet(state)
    rows += time_pointnet_eva(state)
    rows += time_pointnet_bwd_eva(state)
    rows += time_train_pct(state)
    rows += time_oa(state)
    rows += time_full_pct(state)
    rows += time_wide_ops(state)
    rows += time_f32_forms(state)
    time_attention_yardstick(state)
    state["rows"] = rows


def time_pointnet(state: dict) -> list[dict]:
    """The PointNet kernels at the training O (one launch each per step),
    and the forward at the serving O. No single PyTorch call computes
    either, so library_ms is null."""
    import torch

    from sgaligner_tpu_torch.ops import pointnet_fused

    rows = []
    for name, o in (("pointnet_fwd", state["train_o"]), ("pointnet_bwd", state["train_o"]),
                    ("pointnet_fwd", state["serve_o"])):
        source, replaces = KERNELS[name]
        kern, plain = op_fns(name)
        args = op_inputs(name, o, torch.bfloat16, seed=2)
        err_abs, err_rel = check_op(name, args, "bf16", what=f"time: {name} at O={o}")
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        work = bwd_work(args) if name == "pointnet_bwd" else None
        b_ms, b_by = bound(name, o, work=work)
        if work:
            tiles = int(float(pointnet_fused.last_bwd_grads[-1]))
            log(f"[time] pointnet_bwd O={o}: {work[0]} rows and {work[1]} channels "
                f"carry gradient (of {o * P} and {o * PN[-1]}); the kernel ran {tiles} "
                f"tiles of 64 rows, the routing fills {work[2]}")
            if tiles != work[2]:
                raise AssertionError(f"pointnet_bwd ran {tiles} row tiles, the routed rows "
                                     f"fill {work[2]}")
            log_redesign(state, name, o, ms, b_ms, kern, args)
        if name == "pointnet_fwd" and o in POINTNET_WMMA_MS:
            earlier = POINTNET_WMMA_MS[o]
            log(f"[time] pointnet_fwd O={o} bf16: {ms:.3f} ms, {b_ms / ms:.1%} of its bound; "
                f"the WMMA design {earlier} ms ({b_ms / earlier:.1%}) | {state['card']}")
        log(f"[time] {name:15s} O={o} bf16 kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | "
            f"bound {b_ms:.4f} ms ({b_by}) | library None | max_abs {err_abs:.3e} "
            f"max_rel {err_rel:.3e} | {state['card']}")
        if o == state["train_o"]:
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": state["launches_train"][name],
                         "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del args
        torch.cuda.empty_cache()
    kern_ms = sum(r["ms"] for r in rows)
    step_ms = state["train_step_ms"]
    log(f"[time] point train step {step_ms:.2f} ms: the two PointNet kernels "
        f"{kern_ms:.3f} ms ({kern_ms / step_ms:.1%}), the rest (GAT, embeddings, "
        f"losses, Adam, the finite check, host) {step_ms - kern_ms:.2f} ms | {state['card']}")
    return rows


def time_pointnet_eva(state: dict) -> list[dict]:
    """The PointNet forward at EVA's C3 = 200 (the wrapper pads W3 and b3
    to the kernel's width and crops the output) at the training O and the
    serving O, bf16; its bound counts the 200 real channels. The row's
    launches are the quality phase's EVA runs'. Beside it, the quality
    runs' request times."""
    import torch

    source, replaces = KERNELS["pointnet_fwd"]
    kern, plain = op_fns("pointnet_fwd")
    rows = []
    for o in (state["train_o"], state["serve_o"]):
        args = op_inputs("pointnet_fwd", o, torch.bfloat16, seed=2, c3=EVA_C3)
        err_abs, err_rel = check_op("pointnet_fwd", args, "bf16",
                                    what=f"time: pointnet_fwd C3={EVA_C3} at O={o}")
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        b_ms, b_by = bound("pointnet_fwd", o, c3=EVA_C3)
        log(f"[time] pointnet_fwd C3={EVA_C3} O={o} bf16 kernel {ms:.3f} ms | plain "
            f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it) | "
            f"library None | max_abs {err_abs:.3e} max_rel {err_rel:.3e} | {state['card']}")
        if o == state["train_o"]:
            rows.append({"name": f"pointnet_fwd/C3={EVA_C3}", "route": "cuda",
                         "source": source, "replaces": replaces,
                         "launches": state["launches_quality_eva"],
                         "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del args
        torch.cuda.empty_cache()
    for (name, dtype), ms in state["quality_ms"].items():
        log(f"[time] quality {name} {dtype}: median request {ms:.2f} ms (8 pairs, "
            f"{8 / ms * 1e3:.1f} pairs/s) | {state['card']}")
    return rows


def time_pointnet_bwd_eva(state: dict) -> list[dict]:
    """The bf16 PointNet backward at EVA's C3 = 200 (the wrapper pads W3,
    b3, dout, peak and amax to 208 and crops dW3 and db3) beside the kernel
    at 208 and 256 on the same points; then the f32 forms of both PointNet
    kernels (rows 14 and 15 as the EVA recipe trains them; any C3, no
    padding) at C3 = 200 and 256. Each at the EVA retrain's O and the
    training O, beside its plain version and its bound (the backward's from
    the rows and channels that carry gradient, bwd_work); the f32 forms at
    the retrain's O and C3 = 200 also beside their first versions' times
    (F32_FIRST_MS), the backward with its passes under torch.profiler. The
    rows (f32 at the retrain's O and C3 = 200, the main path's forms) take
    their launches from the trainer phase's retrain."""
    import torch

    from sgaligner_tpu_torch.ops import pointnet_fused

    kern, plain = op_fns("pointnet_bwd")
    for o in (EVA_TRAIN_O, state["train_o"]):
        widths = {}
        for c3 in (EVA_C3, 208, PN[-1]):
            args = op_inputs("pointnet_bwd", o, torch.bfloat16, seed=2, c3=c3)
            widths[c3] = cuda_ms(lambda: kern(*args))
            if c3 == EVA_C3:
                err_abs, err_rel = check_op("pointnet_bwd", args, "bf16",
                                            what=f"time: pointnet_bwd C3={c3} O={o}")
                plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
                b_ms, b_by = bound("pointnet_bwd", o, work=bwd_work(args), c3=c3)
            del args
        ms = widths[EVA_C3]
        log(f"[time] pointnet_bwd C3={EVA_C3} O={o} bf16 kernel {ms:.3f} ms (the kernel at "
            f"C3 = 208 {widths[208]:.3f}, at 256 {widths[PN[-1]]:.3f}) | plain {plain_ms:.3f} ms "
            f"| bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it) | library None | max_abs "
            f"{err_abs:.3e} max_rel {err_rel:.3e} | {state['card']}")
        torch.cuda.empty_cache()
    rows = []
    launches = {"pointnet_fwd": state["launches_trainer_eva_fwd"],
                "pointnet_bwd": state["launches_trainer_eva"]}
    for name in POINT_KERNELS:
        kern, plain = op_fns(name)
        for o in (EVA_TRAIN_O, state["train_o"]):
            for c3 in (EVA_C3, PN[-1]):
                args = op_inputs(name, o, torch.float32, seed=2, c3=c3)
                err_abs, err_rel = check_op(name, args, "f32",
                                            what=f"time: {name} f32 C3={c3} O={o}")
                ms = cuda_ms(lambda: kern(*args))
                plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
                work = bwd_work(args) if name == "pointnet_bwd" else None
                b_ms, b_by = bound(name, o, work=work, c3=c3, f32=True)
                note = ""
                if work:
                    tiles = int(float(pointnet_fused.last_bwd_grads[-1]))
                    if tiles != work[2]:
                        raise AssertionError(f"pointnet_bwd f32 ran {tiles} row tiles, the "
                                             f"routed rows fill {work[2]}")
                    note = (f" | {work[0]} rows and {work[1]} channels carry gradient, "
                            f"{tiles} row tiles")
                main = (o, c3) == (EVA_TRAIN_O, EVA_C3)
                if name == "pointnet_fwd" and (o, c3) == (EVA_TRAIN_O, PN[-1]):
                    # the downstream phase's testers: the full snapshot at
                    # f32, eval batches of 8 pairs (O = 256)
                    rows.append({"name": f"{name}/C3={c3}/f32", "route": "cuda",
                                 "source": "sgaligner_tpu_torch/csrc/pointnet.cu",
                                 "replaces": KERNELS[name][1],
                                 "launches": state["launches_downstream"],
                                 "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                if main:
                    first = F32_FIRST_MS[name]
                    note += f" | the first version {first} ms ({first / ms:.1f}x this)"
                    if work:
                        split = pass_split(lambda: kern(*args), POINTNET_F32_BWD_PASSES)
                        note += " | passes (torch.profiler, ms a call): " + ", ".join(
                            f"{k[2:].replace('_kernel', '')} {split.get(k, 0.0):.4f}"
                            for k in POINTNET_F32_BWD_PASSES)
                log(f"[time] {name} f32 C3={c3} O={o} kernel {ms:.3f} ms | plain "
                    f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of "
                    f"it) | library None | max_abs {err_abs:.3e} max_rel {err_rel:.3e}{note} "
                    f"| {state['card']}")
                if main:
                    rows.append({"name": f"{name}/C3={EVA_C3}/f32", "route": "cuda",
                                 "source": "sgaligner_tpu_torch/csrc/pointnet.cu",
                                 "replaces": KERNELS[name][1], "launches": launches[name],
                                 "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                del args
                torch.cuda.empty_cache()
    for tag, ms in zip(("first half", "resumed half"), state["trainer_eva_ms"]):
        log(f"[time] trainer eva {tag}: {ms:.2f} ms a step (the Trainer's process time, "
            f"f32, O={EVA_TRAIN_O}) | {state['card']}")
    return rows


def log_redesign(state: dict, label: str, o: int, ms: float, b_ms: float, kern,
                 args) -> None:
    """A redesigned training kernel beside its earlier design's time
    (WMMA_BWD_MS, WMMA_FWD_MS) and its passes' device time under
    torch.profiler (pass_split)."""
    passes = {"pct_tail_bwd": TAIL_BWD_PASSES, "embed_second": EMBED_SECOND_PASSES,
              "pct_block_fwd": BLOCK_FWD_PASSES,
              "embed_second_bwd": EMBED_SECOND_BWD_PASSES,
              "pointnet_bwd": POINTNET_BWD_PASSES,
              "pct_epi_sums": EPI_SUMS_PASSES,
              "embed_first_bwd": EMBED_FIRST_BWD_PASSES,
              "pct_attn_fwd": ATTN_FWD_PASSES}.get(label.split("/")[0], BLOCK_BWD_PASSES)
    earlier = {**WMMA_BWD_MS, **WMMA_FWD_MS, **FIRST_MS}[label]
    split = pass_split(lambda: kern(*args), passes)
    log(f"[time] {label} O={o} bf16: {ms:.3f} ms, {b_ms / ms:.1%} of its bound; the earlier "
        f"design {earlier} ms | passes (torch.profiler, ms a call): "
        + ", ".join(f"{k[2:].replace('_wgmma_kernel', '').replace('_kernel', '')} "
                    f"{split.get(k, 0.0):.3f}" for k in passes) + f" | {state['card']}")


def time_train_pct(state: dict) -> list[dict]:
    """The pct training kernels at the training O, each with its launches
    over the train_pct windows, the tail's indexed forward and embed_second
    (the bf16 forward's redesigns beside their earlier times). No single
    PyTorch call computes any of them (library_ms null); for the tail's
    backward the dx product alone, one torch.matmul, is timed and logged."""
    import torch

    o = state["train_pct_o"]
    launches = state["launches_train_pct"]
    steps = N_WINDOWS * WINDOW_STEPS
    rows, per_step_ms = [], 0.0
    # besides the rows: the tail's indexed forward and embed_second, one
    # launch each per step (embed_second's row is at the serving O)
    extra_fwd = [("pct_tail", "idx"), ("embed_second", "step")]
    for name, flags in [(n, None) for n in TRAIN_KERNELS] + extra_fwd:
        source, replaces = KERNELS[name]
        kern, plain = op_fns(name, flags or (True, False))
        args = op_inputs(name, o, torch.bfloat16, seed=2)
        err_abs, err_rel = check_op(name, args, "bf16", flags or (True, False),
                                    what=f"time: {name} at O={o}")
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        b_ms, b_by = bound(name, o)
        extra = ""
        if name == "pct_tail_bwd":
            g = torch.randn(o * P, K, device="cuda", dtype=torch.bfloat16)
            w_t = args[4].t()
            extra = (f" | dx product alone (one torch.matmul [O·P,{K}]·[{K},{4 * C}]) "
                     f"{cuda_ms(lambda: torch.matmul(g, w_t)):.3f} ms")
            del g
        per_step_ms += PER_PCT_TRAIN_STEP.get(name, 0) * ms if flags is None else ms
        label = name + ("/idx" if flags == "idx" else "")
        if label in WMMA_BWD_MS or label in WMMA_FWD_MS or label in FIRST_MS:
            log_redesign(state, label, o, ms, b_ms, kern, args)
        log(f"[time] {label:17s} O={o} bf16 kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | "
            f"bound {b_ms:.4f} ms ({b_by}) | library None{extra} | launches per step "
            f"{launches[name] / steps:g} | max_abs {err_abs:.3e} max_rel {err_rel:.3e} | "
            f"{state['card']}")
        if flags is None:
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del args
        torch.cuda.empty_cache()
    step_ms = state["train_pct_ms"]
    log(f"[time] pct train step {step_ms:.2f} ms: the training kernels, the indexed "
        f"tail forward and embed_second {per_step_ms:.2f} ms per step "
        f"({per_step_ms / step_ms:.1%}; embed_first not counted) | {state['card']}")
    return rows


def time_oa(state: dict) -> list[dict]:
    """The ops' kernels (rows 7, 10, 11) with both flag sets and the OA
    variants of the block kernels (rows 5, 6, 9) at the training O, each
    with its launches (phases ops and spct) and its bound. No single PyTorch
    call computes any of them (library_ms null); time_attention_yardstick
    logs the same-work yardstick of rows 10 and 11."""
    import torch

    o = state["spct_o"]
    counted = {"ops/SA": state["launches_ops"]["SA"], "ops/OA": state["launches_ops"]["OA"],
               "spct_eval": state["launches_spct_eval"],
               "spct_train": state["launches_spct_train"]}
    rows = []
    for name, flags, where in OA_ROWS:
        tag = "OA" if flags == OA else "SA"
        label = name if flags == SA else f"{name}/OA"
        source, replaces = KERNELS[name]
        kern, plain = op_fns(name, flags)
        args = op_inputs(name, o, torch.bfloat16, seed=2)
        err_abs, err_rel = check_op(name, args, "bf16", flags, what=f"time: {label} at O={o}")
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        b_ms, b_by = bound(name, o, oa=flags == OA)
        launches = counted[f"ops/{tag}" if where == "ops" else where][name]
        if label in WMMA_BWD_MS or label in WMMA_FWD_MS or label in FIRST_MS:
            log_redesign(state, label, o, ms, b_ms, kern, args)
        log(f"[time] {label:20s} O={o} bf16 kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | "
            f"bound {b_ms:.4f} ms ({b_by}) | library None | launches {launches} ({where}) | "
            f"max_abs {err_abs:.3e} max_rel {err_rel:.3e} | {state['card']}")
        rows.append({"name": label, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "max_abs_err": err_abs, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        del args
        torch.cuda.empty_cache()
    return rows


def time_full_pct(state: dict) -> list[dict]:
    """The C = 256 block kernels with FullPCT's OA flags at its full-width
    O = 256, P = 256, bf16 then f32 (bound at the f32 rate), each with its
    launches in phase full_pct's timed calls and the plain version's time.
    No single PyTorch call computes any of them (library_ms null)."""
    import torch

    o = WIDE_O
    rows = []
    for dt_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        counted = state["launches_full_pct"][dt_name]
        for wide in (*PER_FULL_PCT_EVAL, *PER_FULL_PCT_TRAIN):
            name = WIDE[wide]
            flags = SA if name == "pct_epi_sums" else OA
            label = wide + ("" if name == "pct_epi_sums" else "/OA") + (
                "/f32" if dt_name == "f32" else "")
            kern, plain = op_fns(name, flags)
            args = untied(name, op_inputs(name, o, dtype, seed=2, p=WIDE_P, c=WIDE_C), flags)
            err_abs, err_rel = check_op(name, args, dt_name, flags,
                                        what=f"time: {label} at O={o}")
            ms = cuda_ms(lambda: kern(*args))
            plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
            b_ms, b_by = bound(name, o, WIDE_P, oa=flags == OA, f32=dt_name == "f32", c=WIDE_C)
            launches = counted["eval" if name == "pct_block_eval" else "train"][wide]
            log(f"[time] {label:28s} O={o} P={WIDE_P} C={WIDE_C} kernel {ms:.3f} ms | plain "
                f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | library None | launches "
                f"{launches} (full_pct, {FULL_PCT_CALLS} calls) | max_abs {err_abs:.3e} "
                f"max_rel {err_rel:.3e} | {state['card']}")
            source = ("sgaligner_tpu_torch/csrc/pct_epi_sums.cu" if name == "pct_epi_sums"
                      else "sgaligner_tpu_torch/csrc/pct_attention_c256.cu")
            rows.append({"name": label, "route": "cuda", "source": source,
                         "replaces": KERNELS[name][1], "launches": launches,
                         "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
            del args
            torch.cuda.empty_cache()
    return rows


def time_wide_ops(state: dict) -> list[dict]:
    """The ops' C = 256 kernels (rows 7, 10, 11) with both flag sets at
    FullPCT's O = 256, P = 256, bf16 then f32 (bound at the f32 rate), each
    with its launches in phase ops and the plain version's time. No single
    PyTorch call computes any of them (library_ms null);
    time_attention_yardstick logs the same-work yardstick of rows 10 and 11
    at this width."""
    import torch

    rows = []
    for dt_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for wide in ("pct_block_bwd_c256", "pct_attn_fwd_c256", "pct_attn_bwd_c256"):
            name = WIDE[wide]
            for tag, flags in (("SA", SA), ("OA", OA)):
                label = wide + ("/OA" if flags == OA else "") + (
                    "/f32" if dt_name == "f32" else "")
                kern, plain = op_fns(name, flags)
                args = op_inputs(name, WIDE_O, dtype, seed=2, p=WIDE_P, c=WIDE_C)
                err_abs, err_rel = check_op(name, args, dt_name, flags,
                                            what=f"time: {label} at O={WIDE_O}")
                ms = cuda_ms(lambda: kern(*args))
                plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
                b_ms, b_by = bound(name, WIDE_O, WIDE_P, oa=flags == OA, f32=dt_name == "f32",
                                   c=WIDE_C)
                launches = state["launches_ops_c256"][dt_name][tag][wide]
                log(f"[time] {label:28s} O={WIDE_O} P={WIDE_P} C={WIDE_C} kernel {ms:.3f} ms | "
                    f"plain {plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | library None | "
                    f"launches {launches} (ops, one call) | max_abs {err_abs:.3e} max_rel "
                    f"{err_rel:.3e} | {state['card']}")
                rows.append({"name": label, "route": "cuda",
                             "source": "sgaligner_tpu_torch/csrc/pct_attention_c256.cu",
                             "replaces": KERNELS[name][1], "launches": launches,
                             "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                del args
                torch.cuda.empty_cache()
    return rows


def time_f32_forms(state: dict) -> list[dict]:
    """The f32 forms of every kernel but the PointNet pair, pct_epi_sums and
    embed_first_bwd (whose f32 forms are timed beside their bf16 ones) at
    O = 896, P = 512: CUDA-event ms, the plain version's ms, the bound at the
    f32 rate, and the launches of each (every flag set) in the phases that
    run them: parity, train_pct_parity and oa_parity. The tail pair, the
    f32 C = 128 block forms of rows 5, 6 and 9 and the embed_second pair
    (rows 3, 4; all on tail_f32.cuh's mainloop; row 1 is a first version)
    also give rows of the {"kernels": ...} line, each with the launches of
    the path that runs its form alone (the serving forms: parity's f32
    serving request; the indexed tail, its backward, rows 6, 9, 3 and 4:
    train_pct's f32 step windows), held to its plain version (library null
    for the block forms, whose function no single call computes): the tail
    forward and row 3 with one torch.matmul of their product at f32 as
    their library time, the backwards (row 13: z, dX = g·Wᵀ, dW = xᵀ·g;
    row 4: h, dW1 = x0ᵀ·dz, dx0 = dz·W1ᵀ) with their three products as
    torch.matmul calls logged as a yardstick (no single call computes
    them: library null)."""
    import torch

    o = state["train_o"]
    launches = state.get("launches_f32", {})
    # each row's form and the path whose run alone launched it
    path_launches = {"": state["launches_serve_f32"]["pct_tail"],
                     "idx": state["launches_train_pct_f32"]["pct_tail"],
                     "bwd": state["launches_train_pct_f32"]["pct_tail_bwd"]}
    # the redesigned f32 C = 128 block forms on the paths that run them: the
    # f32 serving request (row 5) and the f32 step windows (rows 6, 9)
    block_paths = {"pct_block_eval": ("launches_serve_f32", "the f32 serving request"),
                   "pct_block_fwd": ("launches_train_pct_f32", "the f32 step windows"),
                   "pct_block_res_bwd": ("launches_train_pct_f32", "the f32 step windows")}
    rows = []
    for name in KERNELS:
        if name in (*POINT_KERNELS, "pct_epi_sums", "embed_first_bwd"):
            continue
        variants = ([("SA", SA), ("OA", OA)] if name in ATTN_FNS else
                    [("", SA), ("idx", "idx")] if name == "pct_tail" else [("", SA)])
        for tag, flags in variants:
            kern, plain = op_fns(name, flags)
            args = op_inputs(name, o, torch.float32, seed=2)
            tail = name.startswith("pct_tail")
            ms = cuda_ms(lambda: kern(*args), warmup=1, reps=5 if tail else 3)
            plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
            b_ms, b_by = bound(name, o, oa=flags == OA, f32=True)
            library, library_ms, err = "", None, ""
            if tail:
                cat_x = torch.cat(args[:4], dim=-1).reshape(o * P, 4 * C)
                z_ms = cuda_ms(lambda: torch.matmul(cat_x, args[4]))
                if name == "pct_tail":
                    library_ms = z_ms
                    library = f"library {z_ms:.3f} ms | "
                else:
                    g = torch.randn(o * P, K, device="cuda")
                    w_t = args[4].t()
                    dx_ms = cuda_ms(lambda: torch.matmul(g, w_t))
                    dw_ms = cuda_ms(lambda: torch.matmul(cat_x.t(), g))
                    library = (f"yardstick: its products as torch.matmul calls, z {z_ms:.3f} + "
                               f"dX = g·Wᵀ {dx_ms:.3f} + dW = xᵀ·g {dw_ms:.3f} = "
                               f"{z_ms + dx_ms + dw_ms:.3f} ms | ")
                    del g
                del cat_x
                err_abs, err_rel = judge(name, "f32", flags, args, kern(*args), plain(*args),
                                         plain, f"time: f32 {name} at O={o}")
                form = tag if name == "pct_tail" else "bwd"
                n = path_launches[form]
                path = "the f32 serving request" if form == "" else "the f32 step windows"
                err = (f"max_abs {err_abs:.3e} max_rel {err_rel:.3e} | launches {n} on its "
                       f"path ({path}) | ")
                rows.append({"name": f"{name}{'/' + tag if tag else ''}/f32", "route": "cuda",
                             "source": f32_source(name), "replaces": KERNELS[name][1],
                             "launches": n, "max_abs_err": err_abs,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": library_ms})
            if name in ("embed_second", "embed_second_bwd"):
                # rows 3, 4 on the f32 step windows' path (the forward also
                # runs once in the f32 serving request)
                err_abs, err_rel = judge(name, "f32", flags, args, kern(*args), plain(*args),
                                         plain, f"time: f32 {name} at O={o}")
                x0 = torch.relu(args[0] * args[1] + args[2]).reshape(o * P, C)
                h_ms = cuda_ms(lambda: torch.matmul(x0, args[3]))
                if name == "embed_second":
                    library_ms = h_ms
                    library = f"library {h_ms:.3f} ms (one torch.matmul of its product) | "
                else:
                    dz = torch.randn(o * P, C, device="cuda")
                    w_t = args[3].t()
                    dw_ms = cuda_ms(lambda: torch.matmul(x0.t(), dz))
                    dx_ms = cuda_ms(lambda: torch.matmul(dz, w_t))
                    library = (f"yardstick: its products as torch.matmul calls, h {h_ms:.3f} + "
                               f"dW1 = x0ᵀ·dz {dw_ms:.3f} + dx0 = dz·W1ᵀ {dx_ms:.3f} = "
                               f"{h_ms + dw_ms + dx_ms:.3f} ms | ")
                    del dz
                del x0
                n = state["launches_train_pct_f32"][name]
                served = state["launches_serve_f32"][name]
                err = (f"max_abs {err_abs:.3e} max_rel {err_rel:.3e} | launches {n} on its "
                       f"path (the f32 step windows; {served} in the f32 serving request) | ")
                rows.append({"name": f"{name}/f32", "route": "cuda", "source": f32_source(name),
                             "replaces": KERNELS[name][1], "launches": n,
                             "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
            if name in block_paths and flags == SA:
                # the backward on untied inputs: at O = 896 relu ties route
                # either way (see untied)
                held = untied(name, args, flags)
                err_abs, err_rel = judge(name, "f32", flags, held, kern(*held), plain(*held),
                                         plain, f"time: f32 {name} at O={o}")
                del held
                key, path = block_paths[name]
                n = state[key][name]
                err = (f"max_abs {err_abs:.3e} max_rel {err_rel:.3e} | launches {n} on its "
                       f"path ({path}) | ")
                rows.append({"name": f"{name}/SA/f32", "route": "cuda",
                             "source": f32_source(name), "replaces": KERNELS[name][1],
                             "launches": n, "max_abs_err": err_abs,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": None})
            log(f"[time] f32 form {name}{'/' + tag if tag else ''} O={o}: kernel {ms:.3f} ms | "
                f"plain {plain_ms:.3f} ms | {library}bound {b_ms:.4f} ms ({b_by}, the f32 rate) "
                f"| {err}launches {launches.get(name, 0)} (parity, train_pct_parity, oa_parity; "
                f"every flag set) | {f32_source(name)} | {state['card']}")
            del args
            torch.cuda.empty_cache()
    return rows


def f32_source(name: str) -> str:
    """The file of a kernel's f32 form (the f32 C = 128 attention passes:
    pct_attention.cu's launches of csrc/attn_f32.cuh's jobs)."""
    if name.startswith("embed"):
        return "sgaligner_tpu_torch/csrc/pct_embed.cu"
    return ("sgaligner_tpu_torch/csrc/pct_tail.cu" if name.startswith("pct_tail")
            else "sgaligner_tpu_torch/csrc/pct_attention.cu")


def time_attention_yardstick(state: dict) -> None:
    """scaled_dot_product_attention(q, q, v, scale=1) at the block's shapes
    (per object: q [P, da], v [P, C], bf16; C = 128 at the serving and
    training O, C = 256 at FullPCT's O = 256, P = 256), forward and forward
    plus backward. It does the attention core's work (E = q qᵀ, softmax,
    times v) but normalises each row by its own log-sum-exp, where the core
    normalises by the key's: a yardstick of a library flash attention on
    the same work, not the same function and on no path."""
    import torch
    import torch.nn.functional as F

    for tag, o, p, c in (("serving", state["serve_o"], P, C),
                         ("training", state["train_pct_o"], P, C),
                         ("C = 256", WIDE_O, WIDE_P, WIDE_C)):
        g = torch.Generator().manual_seed(3)
        da = c // 4
        q = (torch.randn(o, 1, p, da, generator=g) * da ** -0.25).to("cuda", torch.bfloat16)
        v = torch.randn(o, 1, p, c, generator=g).to("cuda", torch.bfloat16)
        dy = torch.randn(o, 1, p, c, generator=g).to("cuda", torch.bfloat16)
        try:
            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, q, v, scale=1.0))
            qg, vg = q.clone().requires_grad_(True), v.clone().requires_grad_(True)

            def both():
                out = F.scaled_dot_product_attention(qg, qg, vg, scale=1.0)
                torch.autograd.grad(out, (qg, vg), dy)

            fb = cuda_ms(both)
            log(f"[time] attention yardstick ({tag}, O={o}, P={p}, C={c}): "
                f"scaled_dot_product_attention(q, q, v) forward {fwd:.3f} ms, forward + "
                f"backward {fb:.3f} ms | {state['card']}")
        except (RuntimeError, torch.OutOfMemoryError) as err:
            log(f"[time] attention yardstick ({tag}, O={o}): not measured ({err})")
        del q, v, dy
        torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:2] == ["--downstream-cpu"]:
        return downstream_cpu_main(sys.argv[2], int(sys.argv[3]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "sgaligner_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port (sgaligner_tpu_torch/) is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    state: dict = {}
    phase_device(state)
    try:
        run_phases(state)
    finally:
        stop_downstream_cpu(state)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(state["card"])
    print(json.dumps({"kernels": state["rows"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(state: dict) -> None:
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("parity", phase_parity), ("train_parity", phase_train_parity),
                        ("train_pct_parity", phase_train_pct_parity),
                        ("oa_parity", phase_oa_parity),
                        ("serve", phase_serve), ("train", phase_train),
                        ("train_pct", phase_train_pct), ("serve_point", phase_serve_point),
                        ("artifact", phase_artifact), ("register", phase_register),
                        ("spct", phase_spct), ("ops", phase_ops),
                        ("full_pct", phase_full_pct),
                        ("quality", phase_quality), ("downstream", phase_downstream),
                        ("trainer", phase_trainer), ("downstream_cpu", phase_downstream_cpu),
                        ("dp", phase_dp), ("time", phase_time)):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
