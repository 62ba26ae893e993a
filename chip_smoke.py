#!/usr/bin/env python3
"""Drive the PyTorch port's mAR-SCF training and serving paths on one
NVIDIA card.

    python3 chip_smoke.py [--out DIR] [--seed N] [--profile]

Phases, each of which raises (exit code != 0) when it fails:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc compiles every kernel source of gpnf_tpu_torch/csrc at once;
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the paths' shapes (batch 64, the three levels), with its time, the
     plain version's time, a library call's time where one PyTorch call
     computes the same function, and its bound on this card; the
     attention forward (two stages: the projection GEMM, then the
     tensor-core forward, each timed alone) at dropout rate 0 and 0.2
     (one seed for kernels and plain version: the same mask), its
     backward at 0 and 0.2 (dseq, dW), each two calls bit for bit the
     same, and the backward's stages at each level's shapes: the
     projection, dseq and dW GEMMs against torch.matmul (torch.mm beside
     them) and the key-tiled dq and dK/dV kernels (on the tensor cores) at
     rate 0 and 0.2 against their plain version (SDPA's backward beside
     them), each two calls bit for bit; the bounds with their products (on
     the tensor cores) at 3xTF32's rate, the fp32 rate's beside them; the
     mixture kernels at K 32 (and K 48 at level 0), each two calls bit for
     bit, the inverse equal to its plain version (which sums over the
     components in the kernel's lane-group order) with CDF(x) = y within
     2e-6, the forward within 1e-5;
  4. train: the flagship model (32x32x3, L=3, K=4, hidden 96, 10 blocks,
     32 components, ConvLSTM prior, dropout 0.2; random weights from
     --seed) after ddi, 20 Adamax steps at batch 64 with a 64-sample
     warmup: every loss finite and the last 5 below the first, the launch
     counts per step; then train images/s (median of 3 windows of 10
     steps), peak device memory, one step at batch 256, and a checkpoint
     written and restored bit for bit;
  5. serve: the same configuration after ddi, in eval mode, test bits/dim
     over 4 synthetic batches of 64, with the launch counts;
  6. sample: a 64-image ancestral-sample grid written as a PNG;
  7. card vs CPU: encode bits/dim and eps_std=0 samples on the same
     weights, each level's K steps run forward then inverse on the card,
     and one training step at batch 4, dropout 0 (loss and gradient);
  8. timings: eval and sample images/s at batch 64, peak device memory;
  9. with --profile: device time by kernel over one train step, one eval
     batch and one sampling pass (torch.profiler), and the device's busy
     share;
 10. GP kernels: the Cholesky (n = 1000, 1024, 2048, 4096 in float32 and
     1024 in float64, timed; and untimed the edges of its 16- and 64-wide
     blocking, n = 1, 63, 64, 65, 129, 200, and every size in float64;
     each against the plain version and by its residual, with its upper
     triangle zero and two calls bit for bit the same; NaN without an
     error on a matrix that is not positive definite, the pivot at rows 0,
     64, 128, 300 and in a ragged last tile; its device launches in one
     factorization, 2 ceil(n/64) - 1), the
     triangular solve (n = 1024 and 4096, p = 1 and n, both ways, and the
     posterior's n = 1024, p = 256; its device launches in one solve at
     n = 1024 and 4096, p = 1 and n, `tril_solve_device_launches`), the
     affine coupling ((1024, 384), (1024, 192), (4096, 384)), each with its
     time, the plain version's, the library call's and its bound; and each
     kernel's backward on the card against float64 autograd of the plain
     version on the CPU; the Cholesky's trailing_precision="high" (its
     trailing launch's bf16x3 branch on the tensor cores) against plain
     "high" (1e-5 relative and by the residual) at n = 63, 65, 129, 200,
     1000, 2048 (P 64, 128) and 200, 2048 in float64, and timed at n =
     1024, 2048, 4096 (P 256) and 1024 in float64 beside "highest" on the
     same matrix and cholesky_ex, bound by its bf16x3 products at the bf16
     rate and the rest at fp32's; two calls bit for bit, not "highest"'s
     factor, NaN without an error, 2 ceil(n/64) - 1 device launches, the
     trailing kernel alone (one launch for one panel) against its plain
     version within the float32 sums' spread; then one call through
     `cholesky(a, "high")` at n = 4096 with the counts set to 0 just before
     (cholesky 1, cholesky_high 1). Phases 11 and 12 launch no "high";
 11. the flow -> GP run of `train_gp --flow` at full size (n_train 1024,
     n_test 256, 16x16x3, affine L=2 K=2 hidden 32, Gaussian priors, 100
     pretrain + 150 fit steps each for the raw, frozen and joint models)
     and the tabular mode: every NLML finite and falling, the joint fit
     below the frozen one, positive posterior variances, the launches of
     one joint NLML + gradient at n = 1024 counted from 0 (cholesky 1,
     tril_solve 4, fused_affine_forward 4); then the joint NLML and every
     gradient at n = 128 on the frozen and on the joint model's weights:
     the card against the CPU in float64, and the card's float32 against
     float64 on the CPU taking the card's ReLU pieces;
 12. GP timings: the joint NLML + gradient at n = 1024, 2048 and 4096
     (`bench_flow_gp`), the joint fit's steps/s, peak device memory; with
     --profile, device time by kernel over one joint NLML + gradient at
     n = 1024 and 4096, the Cholesky's kernels listed whatever their rank;
 13. long attention: the long-sequence kernels (forward and backward)
     against their plain versions at the 64-px row's level 0 (batch 64,
     S = 1024) and a ragged (batch 4, S = 576), at dropout rate 0 and 0.2
     (rate 0.2 compared at batch 8: the plain mask at batch 64 needs ~10
     GB), two backward calls bit for bit the same, S = MAX_S_LONG + 1
     (715,827,883, past the kernels' int indices) refused; each
     with its time, the plain version's, SDPA's (rate 0) and its bound
     (forward and backward on the tensor cores: at 3xTF32's rate, the
     fp32 rate's beside it);
 14. the ImageNet-64 row (`bench.py`'s BENCH_IMAGE=64 configuration: the
     flagship at 64x64x3; random weights from --seed, the synthetic set at
     64 px, as no ImageNet-64 files are in the checkout): ddi, 10 Adamax
     steps at batch 64 with dropout 0.2 (every loss finite, the last below
     the first, exact launch counts per step), train images/s (median of 3
     windows of 5 steps) and peak device memory; eval bits/dim over 2
     batches and one 64-image sampling pass as a PNG, each with its launch
     counts and images/s; with --profile, device time by kernel over one
     64-px train step, eval batch and sampling pass;
 15. card vs CPU at 64 px on phase 14's weights, batch 2: encode bits/dim,
     and one training step at dropout 0 (loss and every gradient);
 16. the fused GatedConv (MarScfConfig.fused_gated_conv=True, 3xTF32
     implicit GEMMs on the tensor cores at any C): its forward and backward
     kernels against their plain versions at batch 64 on the 32-px levels'
     16x16, 8x8, 4x4 and the 64-px level 0's 32x32, C = 96, and at batch 16
     on 16x16 and 4x4 at C = 12, 48, 160 and 512 and on 8x8 at C = 512 (the
     --C 512 model's three levels), rate 0 and 0.2 (one seed: the same
     mask), two calls of each bit for bit the same, the device launches of
     each call (the kernel nodes of a CUDA graph that captures it) against
     the source's `gpnf_gated_conv_plan`,
     float64 refused, each C = 96 case with its time, the plain version's,
     the port's unfused chain's (forward, forward + backward) and its bound
     (3xTF32's, fp32's beside it), and C = 512 at 16x16 timed; the flagship
     with the flag on phase 4's seeds and batches (ddi, 10 steps, launches
     120 / 120 gated conv, 120 / 120 attention, 12 mixlogcdf a step, train
     images/s over one window of 10 steps, and peak memory beside phase
     4's), eval over 4 batches and
     one sampling pass on phase 5's weights (120 gated-conv launches each,
     images/s; with --profile, one fused train step traced), fused against
     unfused encode on the card (1e-5 bits/dim), card against CPU at batch
     4 (encode, one training step at dropout 0); the 64-px row with the flag
     on phase 14's weights: one warm-up step, then one window of 5 steps
     (the same depth as phase 14; one window where phase 14 times three)
     with exact launch counts and peak memory, and one eval batch; phase
     18's --C 512 model with the flag: its step-1 loss and encode against
     the unfused model on the same weights at dropout 0 (1e-5 bits/dim),
     then 3 train steps and one eval batch with exact launch counts (60
     gated convs a pass). Every earlier phase asserts that the default path
     launches no gated-conv kernel;
 17. the core attention entries (`fused_attention` on q, k, v and
     `fused_attention_qkv` on packed qkv, which no path of the system
     runs): their four kernels against their plain versions at batch 64,
     4 heads, S = 256 / 64 / 16 / 512 / 100 at Dh = 24 and S = 512 at
     Dh = 64, at the long entry's shapes past the JAX kernels' (S 1024 at
     batch 8 and 2304 at batch 2, Dh 24; Dh 40 and 96, padded to 48 and
     128, at S 256), and the packed forward at Dh = 4, 8, 16, 32, 48 (S =
     256), rate 0 and 0.2 (one seed: the same mask), two calls of each bit
     for bit the same, S = MAX_S_LONG + 1, Dh = 260 and float64 refused,
     each with its
     time, the plain version's, SDPA's (rate 0) and its bound (at 3xTF32's
     rate, every kernel on the tensor cores; the fp32 rate's beside it); at
     rate
     0.2 and one seed the packed entry against the proj entry and, bit for
     bit, the long entry, and the q, k, v entry against the packed one;
     the four entries on bf16 operands at the same shapes (and the split
     one at Dh 4, through its zero-padded copy, and 48), rate 0 and 0.2,
     two calls bit for bit: the forwards within 2^-7 max |v|, the split
     backward within one bf16 ulp of each gradient's largest with at most
     5% of its values differing, the packed one within 2^-7 of each
     third's largest, each with its time, the plain version's, SDPA's on
     bf16 (rate 0) and its bound at the bf16 rate (the exponentials
     within it); S 2304 (a 48 x 48 level 0, past the 2048 the long kernels
     once stopped at): GatedAttn (C 96, batch 2, rate 0.2) forward and
     backward in float32 and bf16 against the same module on the plain
     versions, the bf16 forward at Dh 128 and 256, and the bf16 backward
     at batch 64 (its 170 MB keep-bit scratch); then one drive through
     both entries' autograd in float32 and in bf16 (launches 2 of each
     entry, 1 of each bf16 kernel). Every earlier phase asserts that its
     path launches none of the eight;
 18. GatedAttn at every width: the tensor-core forward and backward (Dh
     = 128 and 256, through the long entry's wrappers) against their plain
     versions at the CLIs' width C = 512 (batch 16, S = 256 / 64 / 16) and
     at C = 1024 (batch 4, S = 256), rate 0 and 0.2 (one seed), two calls
     of each bit for bit the same, each with its time, the plain
     version's, SDPA's (rate 0) and its bound (against 3xTF32's peak, the
     fp32 one beside it), the kernels' registers and spills from the
     build's ptxas report; the wide route's
     GEMM kernels (qkv = seq w^T, dseq, dW at S <= 512, 3xTF32 mma.sync
     tiles, K split where few output tiles meet a long K) against
     torch.matmul at C = 512, two calls bit for bit, with times and bounds
     (3xTF32's, fp32's beside them) and their registers; the whole wide route at C = 512 beside autograd of
     F.linear + SDPA; the flagship's routes (proj at the 32-px levels,
     whose forward runs the projection GEMM and the tensor-core forward,
     and whose backward runs the projection GEMM, the key-tiled dq and
     dK/dV kernels and the dseq and dW GEMMs; the long entry unpadded at
     the 64-px level 0, bit for bit the long kernels on seq w^T); then
     `train_marscf` at its default --C 512 and --coupling
     mixlogcdf on the synthetic set (L 3, K 2, batch 16, 12 steps, the loss
     finite and the last 3 below the first, exact launch counts) and
     `eval_marscf` on its checkpoint (bits/dim over the test set, one
     sampling pass, exact launch counts); with --profile, device time by
     kernel over one C = 512 train step and eval batch. Every earlier phase
     asserts that its path launches no Dh = 128 / 256 kernel, and the GEMM
     and key-tiled kernels exactly as often as its proj calls run their
     stages: one projection GEMM and one long forward a proj forward, the
     four backward stages a proj backward;
 19. serving the flagship in bf16 (MarScfConfig(compute_dtype="bfloat16"),
     `bench.py`'s default): the bf16 qkv GEMM against its plain version
     (within one bf16 ulp plus the fp32 sums' spread) at the flagship's
     three levels and C 512, the bf16 forward on TMA + wgmma (within 2^-7
     max |v|) there, at the 64-px level 0 and at Dh 256 (C 1024, batch
     4), rate 0 and 0.2, two calls bit for bit, out bit for bit the same
     with the statistics' store that training's forward adds (its (m, 1/l)
     within 1e-4 of the plain statistics), each with its time, the plain
     version's, the library call's on bf16 (SDPA beside the forward) and
     its bound at the bf16 rate (the forward's one exponential a score
     beside it), the GEMM's plan (the TMA + wgmma route, its tile, splits
     and ring) and one device launch a call of each (a CUDA graph), bf16
     HGMMA and UTMALDG in the SASS of both, no spill in the forward's;
     then phase 5's weights in bf16: eval bits/dim over
     phase 5's batches (exact launch counts, 2 device launches a proj
     forward, no backward launch) and its gap to phase 5's float32, one
     sampling pass (every image finite), a test batch's latents through
     the sampling path and re-encoded (within 2^-5 of the largest
     latent at each level), card vs CPU at batch 2, eval images/s in bf16 and float32 in turns, peak
     memory; one bf16 eval batch of the 64-px row and of phase 18's --C
     512 model. Every earlier phase asserts that it launches no bf16
     kernel; phases 19, 20 and 21 each that no bf16 GEMM call so far took
     its unaligned route;
 20. training the flagship in bf16 (`bench.py`'s default train step): the
     bf16 dq and dK/dV pair from the forward's statistics against the
     plain bf16 backward (each of dK, dV and dq within 2^-7 of its largest
     |plain|; 2 device launches a call, from a CUDA graph) at the flagship's three
     levels (the proj entry's dq recipe), the 64-px level 0 and C 512 (the
     long entry's), rate 0 and 0.2, and the forward and backward at every
     other head width (Dh 4, 8, 16 run 24 wide, 32, 48, 64 run 128 wide,
     and 256) at rate 0.2; the bf16 GEMM's dseq (one bf16 ulp plus the
     float32 sums' spread; at K = 16,384 also its error over sum |products|
     against float64) at phase 19's shapes, on the TMA + wgmma route, one
     device launch a call with K split inside it; two calls bit for bit
     each; times beside the plain versions', SDPA's autograd backward's and
     torch.matmul's on bf16, and bounds at the bf16 rate; bf16 HMMA in the
     pair's SASS, HGMMA and UTMALDG in the GEMM's; then the
     flagship in bf16 on phase 4's seeds and batches: 20 Adamax steps at
     dropout 0.2 (losses finite and falling, exact launch counts a step:
     every attention product on a bf16 kernel, none on a float32 one), peak
     memory beside phase 4's, train images/s in turns with float32 (2
     windows of 5 steps each), one step card vs CPU at batch 2 (the loss
     against the port's bf16 on the CPU within the larger of 1e-3 and half
     the CPU's bf16-vs-float32 gap; every gradient tensor within its own
     bar, 3 times its CPU bf16 noise, and the whole gradient in L2); one bf16
     train step of the flagship at C 192 (Dh 48, padded) and of phase 18's
     --C 512 model, with exact launch counts;
 21. the flagship in bf16 with the fused GatedConv (`bench.py`'s
     BENCH_FUSED_GCONV=1 step): the bf16 gated-conv kernels (the float32
     kernels' template on bf16 operands, bf16 mma.sync) against their plain
     bf16 versions at batch 64 on the 32-px levels and the 64-px level 0
     (C 96), --C 512's 16x16 and 8x8 at batch 16, and C 12 (the narrow
     path), 48, 160 at batch 4, rate 0 and 0.2 (one seed), out and dx
     within one bf16 ulp of the largest |plain| plus their sums' spread
     with at most 5% (out) and 10% (dx) of their values differing, the
     weight gradients within 4 times the root sum of squares of their
     terms' bf16 rounding errors element by element and 0.18 times it in
     rms (`gated_conv_bf16_readings`, which also reads the plain versions
     with a rounding point moved: each must fail a bar), two calls bit
     for bit, each call's device launches (a CUDA graph) against the
     source's plan, each C 96 case
     timed beside the plain version, the unfused bf16 chain and the
     float32 kernels, bound at the bf16 rate, bf16 HMMA in every bf16
     instantiation's SASS, their registers and spills; then the flagship
     in bf16 with the flag on phase 4's seeds and batches: 10 Adamax steps
     at dropout 0.2 (losses finite and falling, exact launch counts a
     step: 120 / 120 gated convs on the bf16 kernels, none on the float32
     ones, the attention as in phase 20), peak memory beside phase 20's,
     train images/s in turns with phase 20's unfused bf16 step (2 windows
     of 5), one step card vs CPU at batch 2 (phase 20's bars; the same
     step on the card with the gated conv's plain versions in place of its
     kernels logged beside it), one eval batch and one sampling pass with
     exact counts; one bf16 fused train
     step of the 64-px row and of phase 18's --C 512 model, with exact
     launch counts. Every earlier phase asserts that it launches no bf16
     gated-conv kernel.
Each phase logs its time (`phase_s` in chip_smoke.json). The line before
the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. TF32 is off throughout.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import importlib
import itertools
import json
import math
import os
import shutil
import statistics
import sys
import time

import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FLOP/s of
# fp32 outside the tensor cores, which is also the fp64 peak (fp64 on the
# tensor cores, DMMA), and dense TF32 FLOP/s over the three products of
# 3xTF32, the peak of a kernel whose products run on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_OPS_3XTF32 = 495e12 / 3
PEAK_OPS_BF16 = 989e12  # dense bf16 on the tensor cores
BATCH = 64
FLAGSHIP = dict(image_shape=(32, 32, 3), L=3, K=4, hidden_channels=96,
                num_blocks=10, num_components=32, drop_prob=0.2,
                prior_hidden=32, prior_layers=3)
RATE = FLAGSHIP["drop_prob"]
TRAIN_STEPS, WINDOW_STEPS, WINDOWS = 20, 10, 3
WARM_UP = 64  # samples: updates 0 and 1 run at lr 0, full lr from update 2
# (attention S, mixture D = half the level's channels x H x W) per level
LEVELS = [(256, 1536), (64, 768), (16, 384)]
AFFINE_OPS = 10     # per element: add, exp, log1p, two selects, add,
                    # divide, multiply-add, sum
GP_KERNELS = ("fused_affine_forward", "cholesky", "tril_solve")
# the flagship paths launch none; nor does any path the Cholesky's
# trailing_precision="high" (`cholesky_high`, phase 10's own drive)
NO_GP = dict.fromkeys(GP_KERNELS + ("cholesky_high",), 0)
# the titular flow -> GP run (the JAX package's docs/evidence record of
# `train_gp.py --flow`)
GP_RUN = ["--flow", "--n_train", "1024", "--n_test", "256", "--steps", "150",
          "--image_size", "16", "--flow_C", "32", "--flow_pretrain_steps",
          "100", "--device", "cuda"]
GP_PER_STEP = {"cholesky": 1, "tril_solve": 4, "fused_affine_forward": 4}
# phase 10's shapes: the titular n = 1024 (and a ragged 1000), the bench's
# 2048 and 4096; the affine coupling's two levels at n = 1024, and n = 4096
CHOL_CASES = ((1000, torch.float32), (1024, torch.float32),
              (2048, torch.float32), (4096, torch.float32),
              (1024, torch.float64))
# checked, not timed: the edges of the 16- and 64-wide blocking and the
# look-ahead (a tile's factor inside the trailing launch), and every size
# in float64
CHOL_EDGES = tuple((n, dtype) for dtype in (torch.float32, torch.float64)
                   for n in (1, 63, 64, 65, 129, 200)) + tuple(
    (n, torch.float64) for n in (1000, 2048, 4096))
# (n, row of the negative pivot): the first rows of tiles factored inside a
# trailing launch (64, 128), the first pivot, one inside a tile, and one in
# a ragged last tile
CHOL_NAN = ((512, 0), (512, 64), (512, 128), (512, 300), (200, 195))
# trailing_precision="high" (phase 10): timed at the default panel width
# (256 up to n = 4096) beside "highest" and cholesky_ex; checked, not timed,
# at the blocking's edges and other panel widths, (n, P), in float32 and,
# the last two, float64; the trailing kernel alone at (n, P, panel j)
CHOL_HIGH_CASES = ((1024, torch.float32), (2048, torch.float32),
                   (4096, torch.float32), (1024, torch.float64))
CHOL_HIGH_EDGES = ((63, 64), (65, 64), (129, 64), (200, 64), (1000, 128),
                   (2048, 64), (200, 64), (2048, 128))
CHOL_TRAILING = ((1024, 128, 0), (1024, 128, 2), (1000, 64, 5))
SOLVE_SIZES = (1024, 4096)
POSTERIOR_P = 256  # the posterior's L^-1 K_* at n = 1024 (n_test 256)
AFFINE_SHAPES = ((1024, 384), (1024, 192), (4096, 384))
BENCH_SIZES = (1024, 2048, 4096)
# the ImageNet-64 row (bench.py BENCH_IMAGE=64): the flagship at 64 px
IMAGENET64 = dict(FLAGSHIP, image_shape=(64, 64, 3))
TRAIN64_STEPS, WINDOW64_STEPS = 10, 5
FGC = ("fused_gated_conv", "fused_gated_conv_bwd")
# the bf16 gated-conv kernels' own counters (phase 21); a bf16 call counts
# on its entry's too
FGC_BF16 = ("fused_gated_conv_bf16", "fused_gated_conv_bwd_bf16")
NO_FGC = dict.fromkeys(FGC + FGC_BF16, 0)  # the default paths launch none
# the core attention entries (phase 17): no path of the system runs them;
# their bf16 kernels' own counters (a bf16 call counts on its entry's too)
CORE = ("fused_attention", "fused_attention_bwd", "fused_attention_qkv",
        "fused_attention_qkv_bwd")
CORE_BF16 = tuple(name + "_bf16" for name in CORE)
NO_CORE = dict.fromkeys(CORE + CORE_BF16, 0)
# the Dh = 128 / 256 kernels (phase 18): no C = 96 path runs
# them. The GEMMs (the projection and dseq / dW at S <= 512) run on the wide
# route and in every proj call, whose stages are one launch each of
# PROJ_FWD_STAGES (the projection, then the long entry's tensor-core
# forward) and of PROJ_BWD_STAGES (the projection recomputed, the key-tiled
# dq and dK/dV kernels of the long entry's backward, dseq and dW)
LANES = ("attention_lanes", "attention_lanes_bwd")
GEMMS = ("attention_qkv_gemm", "attention_dseq_gemm", "attention_dw_gemm")
# the bf16 kernels (phases 19 and 20): no float32 path launches them
BF16 = ("attention_qkv_gemm_bf16", "attention_fwd_bf16", "attention_bwd_bf16",
        "attention_dseq_gemm_bf16", "attention_dw_gemm_bf16")
NO_WIDE = dict.fromkeys(LANES + GEMMS + BF16, 0)
PROJ_FWD_STAGES = ("attention_qkv_gemm", "fused_attention_long")
PROJ_BWD_STAGES = ("attention_qkv_gemm", "fused_attention_long_bwd",
                   "attention_dseq_gemm", "attention_dw_gemm")


def proj_stages(fwd_calls, bwd_calls=0):
    """The stage launches of `fwd_calls` proj forward and `bwd_calls` proj
    backward calls, with the proj entry's own counts."""
    out = {"fused_attention_proj": fwd_calls,
           "fused_attention_proj_bwd": bwd_calls,
           **dict.fromkeys(PROJ_FWD_STAGES + PROJ_BWD_STAGES, 0)}
    for name in PROJ_FWD_STAGES:
        out[name] += fwd_calls
    for name in PROJ_BWD_STAGES:
        out[name] += bwd_calls
    return out


def plus(counts, **more):
    """counts with `more` added to its entries."""
    return {**counts, **{k: counts.get(k, 0) + v for k, v in more.items()}}


# at 64 px level 0 has S = 32 * 32 = 1024 > 512: the long entry (its
# projection in torch.matmul), 40 calls a pass; levels 1 and 2 the proj
# entry, 80 calls a pass, forward and backward
PER_STEP_64 = plus({"mixlogcdf_forward": 12, "mixture_inverse": 0, **NO_GP,
                    **NO_FGC, **NO_CORE, **NO_WIDE, **proj_stages(80, 80)},
                   fused_attention_long=40, fused_attention_long_bwd=40)
# per eval batch and per sampling pass at 64 px
EVAL_64 = plus({"mixlogcdf_forward": 12, **proj_stages(80)},
               fused_attention_long=40)
SAMPLE_64 = plus({"mixture_inverse": 12, **proj_stages(80)},
                 fused_attention_long=40)
# phase 13's (batch, S): the 64-px level 0, and a ragged sequence
LONG_CASES = ((BATCH, 1024), (4, 576))
LONG_DROPOUT_BATCH = 8  # rate 0.2 is compared with the plain mask here


def log(msg=""):
    print(msg, flush=True)


def bound(bytes_moved, ops, peak_ops=PEAK_OPS, tc_ops=0, bf16_ops=0):
    """(least ms, "bytes" or "operations") at the card's memory rate and
    `peak_ops`: PEAK_OPS for SIMT fp32, PEAK_OPS_3XTF32 for a kernel whose
    products run on the tensor cores; `tc_ops` more operations at
    PEAK_OPS_3XTF32 (a call with some of its work off the tensor cores
    and its products on them), `bf16_ops` more at PEAK_OPS_BF16."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = (ops / peak_ops + tc_ops / PEAK_OPS_3XTF32
             + bf16_ops / PEAK_OPS_BF16)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tensor_core_bound(bytes_moved, ops):
    """(bound_ms, bound_by, the record's fp32 fields, the log's note) of a
    kernel whose products run on the tensor cores in 3xTF32: held to that
    peak, the bound at the fp32 rate beside it."""
    bound_ms, bound_by = bound(bytes_moved, ops, PEAK_OPS_3XTF32)
    fp32_ms, fp32_by = bound(bytes_moved, ops)
    return bound_ms, bound_by, dict(
        bound_peak="3xTF32 165 TFLOP/s", bound_fp32_ms=fp32_ms,
        bound_fp32_by=fp32_by), f"; fp32 {fp32_ms * 1e3:.2f} us"


def ptxas_kernels(report, pattern):
    """[{kernel, registers, spill_stores, spill_loads}] of the entries of a
    ptxas report (nvcc -Xptxas -v) whose mangled name holds `pattern`."""
    rows, row = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            row = {"kernel": name} if pattern in name else None
            if row:
                rows.append(row)
        elif row is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            row["spill_stores"], row["spill_loads"] = nums[1], nums[2]
        elif row is not None and "registers" in line:
            row["registers"] = int(line.split("Used ")[1].split()[0])
    return rows


def max_errs(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-6)
    return float(diff.max()), float(rel.max())


# -- phase 3 -------------------------------------------------------------------
def check_kernels(device, model, timer):
    from gpnf_tpu_torch.ops import kernels, logistic

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

    gen = torch.Generator(device=device).manual_seed(1234)
    randn = lambda *shape, s=1.0: torch.randn(shape, generator=gen,
                                              device=device) * s
    block = model.levels[0].steps[0].coupling.net.blocks[0]
    with torch.no_grad():
        w = block.attn.in_proj.effective_weight().contiguous()  # (288, 96)
    c, heads, k = w.shape[1], block.attn.num_heads, FLAGSHIP["num_components"]
    results = {}

    def record(name, level, err, ms, plain_ms, library_ms, bytes_moved, ops,
               tc_ops=0, **extra):
        """`tc_ops`: the operations that run on the tensor cores (the GEMMs'
        products, the backward's attention products), bound at 3xTF32's
        rate, with the bound at the fp32 rate beside it; `ops` the rest, at
        the fp32 rate."""
        if tc_ops and not ops:  # every product on the tensor cores
            bound_ms, bound_by, fields, _ = tensor_core_bound(bytes_moved,
                                                              tc_ops)
            extra.update(fields)
        else:
            bound_ms, bound_by = bound(bytes_moved, ops, tc_ops=tc_ops)
        if tc_ops and ops:
            fp32_ms, fp32_by = bound(bytes_moved, ops + tc_ops)
            extra.update(bound_peak="products at 3xTF32 165 TFLOP/s",
                         bound_fp32_ms=fp32_ms, bound_fp32_by=fp32_by)
        row = dict(level=level, **extra, max_abs_err=err[0],
                   max_rel_err=err[1], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        results.setdefault(name, []).append(row)
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        tag = "".join(f" {k} {v}" for k, v in extra.items()
                      if not k.startswith("bound"))
        fp32 = (f"; fp32 {extra['bound_fp32_ms'] * 1e3:.2f} us" if tc_ops
                else "")
        log(f"  {name} level {level}{tag}: max abs err {err[0]:.3g} max rel "
            f"err {err[1]:.3g} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
            f"{lib} | bound {bound_ms * 1e3:.2f} us ({bound_by}{fp32})")

    def library_attention(seq, w):
        b, s, _ = seq.shape
        kk, vv, qq = (t.reshape(b, s, heads, c // heads).transpose(1, 2)
                      for t in F.linear(seq, w).split(c, dim=-1))
        return F.scaled_dot_product_attention(qq, kk, vv).transpose(
            1, 2).reshape(b, s, c)

    def library_backward_ms(seq, w, g):
        """Autograd backward of F.linear + SDPA (rate 0), the graph built
        once and its backward timed alone."""
        seq_r, w_r = seq.clone().requires_grad_(), w.clone().requires_grad_()
        with torch.enable_grad():
            out = library_attention(seq_r, w_r)
        return timer(lambda: torch.autograd.grad(out, (seq_r, w_r), g,
                                                 retain_graph=True))

    def sdpa_backward_ms(qkv, g):
        """Autograd backward of SDPA on the heads of qkv (rate 0): the
        library call beside the key-tiled backward stage."""
        b, s, _ = qkv.shape
        k_, v_, q_ = (t_.reshape(b, s, heads, c // heads).transpose(1, 2)
                      .contiguous().requires_grad_() for t_ in qkv.split(
                          c, dim=-1))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q_, k_, v_)
        g4 = g.reshape(b, s, heads, c // heads).transpose(1, 2)
        return timer(lambda: torch.autograd.grad(out, (q_, k_, v_), g4,
                                                 retain_graph=True))

    def check_stages(level, s, seq, w, g, seed, core):
        """The proj backward's stages at this level's shapes, each against
        its plain version: the projection, dseq and dW GEMMs (torch.matmul;
        the bar of phase 18's GEMMs, 1e-5 of the largest |plain|) and the
        key-tiled dq and dK/dV kernels at rate 0 and 0.2 (phase 13's bar,
        1e-4 of the largest |plain|), two calls bit for bit each."""
        rows = BATCH * s
        qkv = kernels.attention_qkv_gemm(seq, w)
        dqkv = kernels.attention_long_qkv_bwd(qkv, g, heads, RATE, seed)
        for name, fn, plain, lib, (m, n, kk) in (
                ("attention_qkv_gemm",
                 lambda: kernels.attention_qkv_gemm(seq, w),
                 lambda: torch.matmul(seq, w.t()),
                 lambda: torch.mm(seq.view(rows, c), w.t()),
                 (rows, 3 * c, c)),
                ("attention_dseq_gemm",
                 lambda: kernels.attention_dseq_gemm(dqkv, w),
                 lambda: torch.matmul(dqkv, w),
                 lambda: torch.mm(dqkv.view(rows, 3 * c), w),
                 (rows, c, 3 * c)),
                ("attention_dw_gemm",
                 lambda: kernels.attention_dw_gemm(dqkv, seq),
                 lambda: torch.einsum("bso,bsc->oc", dqkv, seq),
                 lambda: torch.mm(dqkv.view(rows, 3 * c).t(),
                                  seq.view(rows, c)),
                 (3 * c, c, rows))):
            got, want = fn(), plain()
            if not torch.equal(got, fn()):
                raise AssertionError(f"{name} level {level}: two calls "
                                     f"differ")
            over_scale = float((got - want).abs().max() / want.abs().max())
            if not over_scale <= 1e-5:
                raise AssertionError(f"{name} level {level}: max abs err / "
                                     f"max |plain| {over_scale} > 1e-5")
            record(name, level, max_errs(got, want), timer(fn), timer(plain),
                   timer(lib), 4 * (m * kk + kk * n + m * n), 0,
                   tc_ops=2 * m * n * kk, m=m, n=n, k=kk,
                   tile=fa.gemm_tile(m, n), splits=fa.gemm_splits(m, n, kk),
                   err_over_scale=float(f"{over_scale:.3g}"))
        for rate in (0.0, RATE):
            run = lambda: kernels.attention_long_qkv_bwd(qkv, g, heads, rate,
                                                         seed)
            plain = lambda: kernels.attention_long_plain_bwd(qkv, g, heads,
                                                             rate, seed)
            got, want = run(), plain()
            if not torch.equal(got, run()):
                raise AssertionError(f"key-tiled bwd level {level} rate "
                                     f"{rate}: two calls differ")
            over_scale = float((got - want).abs().max() / want.abs().max())
            if not over_scale <= 1e-4:
                raise AssertionError(f"key-tiled bwd level {level} rate "
                                     f"{rate}: max abs err / max |plain| "
                                     f"{over_scale} > 1e-4")
            record("fused_attention_long_bwd", level, max_errs(got, want),
                   timer(run), timer(plain),
                   sdpa_backward_ms(qkv, g) if rate == 0.0 else None,
                   4 * (2 * rows * 3 * c + rows * c), 0,
                   tc_ops=5 * core + 5 * BATCH * heads * s * s, rate=rate,
                   err_over_scale=float(f"{over_scale:.3g}"))

    def check_mixture(level, d, kk):
        """The mixture kernels at (BATCH, kk, d), each two calls bit for bit:
        the forward within 1e-5 of its plain version, the inverse equal to
        its plain version (which sums in the kernel's order) and CDF(x) = y
        within 2e-6."""
        fmi = kernels.fused_mixture_inverse
        args = (randn(BATCH, d, s=0.5), randn(BATCH, d, s=0.1),
                randn(BATCH, d, s=0.1), randn(BATCH, kk, d),
                randn(BATCH, kk, d), randn(BATCH, kk, d, s=0.3))
        got = kernels.mixlogcdf_forward(*args)
        want = kernels.mixlogcdf_plain(*args)
        again = kernels.mixlogcdf_forward(*args)
        torch.cuda.synchronize()
        for g, wv, a in zip(got, want, again):
            torch.testing.assert_close(g, wv, rtol=1e-5, atol=1e-5)
            if not torch.equal(g, a):
                raise AssertionError(f"mixlogcdf_forward level {level} K "
                                     f"{kk}: two calls differ")
        err = tuple(max(a, b) for a, b in zip(*(max_errs(g, wv)
                                                for g, wv in zip(got, want))))
        record("mixlogcdf_forward", level, err,
               timer(lambda: kernels.mixlogcdf_forward(*args)),
               timer(lambda: kernels.mixlogcdf_plain(*args)), None,
               4 * (3 * BATCH * d + 3 * BATCH * kk * d + 2 * BATCH * d),
               BATCH * d * kk * kernels.fused_mixlogcdf.OPS_PER_COMPONENT,
               K=kk, deterministic=True)

        pi, mu, ls = randn(BATCH, kk, d), randn(BATCH, kk, d, s=2.0), \
            randn(BATCH, kk, d, s=0.4)
        x_true = randn(BATCH, d, s=2.0)  # y = CDF(x): well-conditioned
        y = torch.exp(logistic.mixture_log_cdf(x_true, pi, mu, ls)).clamp(
            1e-5, 1 - 1e-5).contiguous()
        got = kernels.mixture_inverse(y, pi, mu, ls)
        want = kernels.mixture_inverse_plain(y, pi, mu, ls)
        again = kernels.mixture_inverse(y, pi, mu, ls)
        torch.cuda.synchronize()
        # and it inverts: CDF(x) = y, the bar of tests/test_mixture_inverse.py
        residual = float((torch.exp(logistic.mixture_log_cdf(
            got, pi, mu, ls)) - y).abs().max())
        log(f"  mixture_inverse level {level} K {kk}: max |CDF(x) - y| "
            f"{residual:.3g} (bar 2e-6), bit for bit with the plain version "
            f"(groups of {fmi.GROUP})")
        if not torch.equal(got, want) or residual > 2e-6:
            raise AssertionError(
                f"mixture_inverse level {level} K {kk}: max abs err "
                f"{max_errs(got, want)[0]} (bar 0) or residual {residual} "
                f"> 2e-6")
        if not torch.equal(got, again):
            raise AssertionError(f"mixture_inverse level {level} K {kk}: two "
                                 f"calls differ")
        record("mixture_inverse", level, max_errs(got, want),
               timer(lambda: kernels.mixture_inverse(y, pi, mu, ls)),
               timer(lambda: kernels.mixture_inverse_plain(y, pi, mu, ls)),
               None, 4 * (2 * BATCH * d + 3 * BATCH * kk * d),
               BATCH * d * kk * fmi.OPS_PER_COMPONENT, K=kk,
               deterministic=True, residual=float(f"{residual:.3g}"))

    dh = c // heads
    with torch.no_grad():
        for level, (s, d) in enumerate(LEVELS):
            seq, g = randn(BATCH, s, c), randn(BATCH, s, c)
            seed = torch.tensor([4321 + level], dtype=torch.int32,
                                device=device)
            fwd_bytes = 4 * (2 * BATCH * s * c + 3 * c * c)
            scores = BATCH * heads * s * s
            core = 2 * scores * dh  # one S x S x Dh product
            proj = 2 * BATCH * s * c * 3 * c
            qkv = kernels.attention_qkv_gemm(seq, w)
            for rate in (0.0, RATE):
                # one seed for the stages and the plain version: the same
                # mask, so a single differing keep bit shows as an O(p * v)
                # error
                run = lambda: kernels.fused_attention_proj(seq, w, heads, rate,
                                                           seed)
                plain = lambda: kernels.attention_proj_plain(seq, w, heads,
                                                             rate, seed)
                got = run()
                if not torch.equal(got, run()):
                    raise AssertionError(f"attention level {level} rate "
                                         f"{rate}: two calls differ")
                err = max_errs(got, plain())
                if err[0] > 1e-5:
                    raise AssertionError(f"attention level {level} rate "
                                         f"{rate}: max abs err {err[0]} > 1e-5")
                # no PyTorch call draws the kernel's mask: a library time
                # at rate 0 only; the projection and the forward's products
                # on the tensor cores
                record("fused_attention_proj", level, err, timer(run),
                       timer(plain),
                       timer(lambda: library_attention(seq, w))
                       if rate == 0.0 else None,
                       fwd_bytes, 0, tc_ops=proj + 2 * core + 5 * scores,
                       rate=rate, deterministic=True, stages_ms={
                           "attention_qkv_gemm": timer(
                               lambda: kernels.attention_qkv_gemm(seq, w)),
                           "fused_attention_long": timer(
                               lambda: kernels.attention_long_qkv(
                                   qkv, heads, rate, seed))})
            for rate in (0.0, RATE):
                run = lambda: kernels.fused_attention_proj_bwd(seq, w, g, heads,
                                                               rate, seed)
                plain = lambda: kernels.attention_proj_plain_bwd(
                    seq, w, g, heads, rate, seed)
                got, again, want = run(), run(), plain()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"attention bwd level {level} rate "
                                         f"{rate}: two calls differ")
                errs = [max_errs(x, y) for x, y in zip(got, want)]
                # dW sums B*S rows in another order than cuBLAS: held to
                # the scale of each output
                over_scale = 0.0
                for name, x, y in zip(("dseq", "dW"), got, want):
                    scale = float(y.abs().max())
                    diff = float((x - y).abs().max())
                    over_scale = max(over_scale, diff / scale)
                    if diff > 1e-4 * scale:
                        raise AssertionError(
                            f"attention bwd level {level} rate {rate}: {name} "
                            f"max abs err {diff} > 1e-4 x max |plain| {scale}")
                err = tuple(max(e[i] for e in errs) for i in range(2))
                record("fused_attention_proj_bwd", level, err, timer(run),
                       timer(plain),
                       library_backward_ms(seq, w, g) if rate == 0.0 else None,
                       4 * (3 * BATCH * s * c + 2 * 3 * c * c),
                       0, tc_ops=3 * proj + 5 * core, rate=rate,
                       deterministic=True,
                       err_over_scale=float(f"{over_scale:.3g}"))
            check_stages(level, s, seq, w, g, seed, core)

            check_mixture(level, d, k)
        check_mixture(0, LEVELS[0][1], 48)  # K above the old kernels' 32
    return results


# -- phase 4 -------------------------------------------------------------------
def train(device, loader, out_dir, seed, card, fused=False,
          steps=TRAIN_STEPS, windows=WINDOWS):
    """The flagship training path: ddi, then `steps` Adamax steps with
    dropout, then `windows` timed windows of WINDOW_STEPS; with `fused`,
    MarScfConfig(fused_gated_conv=True) on the same seeds and batches
    (phase 16: FGC_TRAIN_STEPS, one window), without the batch-256 step and
    the checkpoint."""
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.checkpoints import CheckpointManager
    from gpnf_tpu_torch.training.loop import bits_per_dim_loss, train_step
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    cfg = MarScfConfig(**FLAGSHIP, fused_gated_conv=fused)
    model = MarScfFlow(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed + 10))
    batches = [torch.from_numpy(b).to(device) for b, _ in zip(loader, range(16))]
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    model.ddi(batches[0], generator=gen)
    model.train()
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=WARM_UP,
                       batch_size=BATCH)
    step = 0

    def one_step():
        nonlocal step
        loss = train_step(model, opt, batches[step % len(batches)], gen)
        step += 1
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(steps)]  # gate: each read
    counts = kernels.launch_counts()
    per_step = {k: v / steps for k, v in counts.items()}
    log(f"  {steps} steps at batch {BATCH}, dropout {RATE}, warmup "
        f"{WARM_UP} samples: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"bits/dim; launches per step {per_step}")
    log(f"  losses {[round(x, 4) for x in losses]}")
    want = {"mixlogcdf_forward": 12, "mixture_inverse": 0, **NO_GP,
            **NO_CORE, **NO_WIDE, **proj_stages(120, 120), **NO_FGC,
            **dict.fromkeys(FGC, 120 if fused else 0)}
    if per_step != want:
        raise AssertionError(f"train launches per step {per_step} != {want}")
    last5 = statistics.mean(losses[-5:])
    if not (all(math.isfinite(x) for x in losses) and last5 < losses[0]):
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if opt.total_notfinite:
        raise AssertionError(f"{opt.total_notfinite} non-finite updates")

    window_s = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            loss = one_step()
        float(loss)  # each window ends in a loss read
        window_s.append(time.perf_counter() - t0)
    images_per_s = WINDOW_STEPS * BATCH / statistics.median(window_s)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"  train {images_per_s:.1f} images/s (median of {windows} windows "
        f"of {WINDOW_STEPS} steps at batch {BATCH}: {window_s} s) [{card}]")
    log(f"  train peak device memory {peak / 2 ** 30:.3f} GiB at batch "
        f"{BATCH} [{card}]")
    out = {"losses": losses, "launches": counts,
           "launches_per_step": per_step, "train_images_per_s": images_per_s,
           "train_window_s": window_s, "train_peak_memory_bytes": peak}
    if fused:
        return out, one_step

    # one step at batch 256 (bench.py's batch): does it fit on this card?
    big = torch.cat([batches[i % len(batches)] for i in range(4)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        opt.zero_grad()
        bits_per_dim_loss(model, big, gen).backward()
        torch.cuda.synchronize()
        peak_256 = torch.cuda.max_memory_allocated(device)
        log(f"  a batch-256 forward and backward fits: peak "
            f"{peak_256 / 2 ** 30:.3f} GiB [{card}]")
    except torch.cuda.OutOfMemoryError:
        peak_256 = None
        log(f"  a batch-256 forward and backward does not fit [{card}]")
    opt.zero_grad()
    del big
    torch.cuda.empty_cache()

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    ckpt.save(step, model, metric=losses[-1])
    restored = MarScfFlow(cfg, device=device,
                          generator=torch.Generator().manual_seed(seed + 12))
    ckpt.restore(restored, best=True)
    want_state, got_state = model.state_dict(), restored.state_dict()
    same = all(torch.equal(want_state[k], got_state[k]) for k in want_state)
    log(f"  checkpoint step_{step}.npz ({len(want_state)} tensors) restored "
        f"bit for bit: {same}")
    if not same or set(want_state) != set(got_state):
        raise AssertionError("checkpoint restore is not bit for bit")
    shutil.rmtree(ckpt_dir)  # 2 x 185 MB
    return {**out, "batch_256_peak_memory_bytes": peak_256}, one_step


# -- phases 5-8 ------------------------------------------------------------------
def serve(model, loader, device, seed):
    """Eval bits/dim over `loader`, with the launch counts of the model's
    path (the gated-conv kernel's when the model has the flag)."""
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import evaluate

    kernels.reset_launch_counts()
    nll = evaluate(model, loader, generator=torch.Generator(
        device=device).manual_seed(seed + 1))
    counts = kernels.launch_counts()
    n_batches = len(loader)
    log(f"  test bits/dim {nll:.4f} over {n_batches} batches of {BATCH}; "
        f"launches {counts}")
    if not (math.isfinite(nll) and nll < 30.0):
        raise AssertionError(f"eval bits/dim {nll} is not finite and < 30")
    fgc = 120 * n_batches if model.cfg.fused_gated_conv else 0
    want = {"mixlogcdf_forward": 12 * n_batches, "mixture_inverse": 0,
            **NO_GP, **NO_CORE, **NO_WIDE, **NO_FGC,
            **proj_stages(120 * n_batches), "fused_gated_conv": fgc}
    if counts != want:
        raise AssertionError(f"eval launches {counts} != {want}")
    return nll, counts


def sample(model, out_dir, device, seed, name="samples.png"):
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import save_sample_grid

    kernels.reset_launch_counts()
    path, nan_count = save_sample_grid(
        model, os.path.join(out_dir, name), n=BATCH, eps_std=1.0,
        generator=torch.Generator(device=device).manual_seed(seed + 2))
    counts = kernels.launch_counts()
    log(f"  wrote {path} ({os.path.getsize(path)} bytes); {nan_count} NaN "
        f"before the clamp; launches {counts}")
    want = {"mixlogcdf_forward": 0, "mixture_inverse": 12, **NO_GP,
            **NO_CORE, **NO_WIDE, **NO_FGC, **proj_stages(120),
            "fused_gated_conv": 120 if model.cfg.fused_gated_conv else 0}
    if counts != want:
        raise AssertionError(f"sampling launches {counts} != {want}")
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{path} is not a PNG")
    return counts, nan_count


def card_vs_cpu(model, batch, device):
    cpu = copy.deepcopy(model).to("cpu")
    z = torch.from_numpy(batch[:8])
    logdet = torch.zeros(8)
    scale = math.log(2.0) * model.num_dims
    with torch.no_grad():
        _, obj_card = model.encode(z.to(device), logdet.to(device))
        _, obj_cpu = cpu.encode(z, logdet)
        bpd_diff = float((obj_card.cpu() - obj_cpu).abs().max()) / scale
        # Random weights make eps_std=0 sampling ill-conditioned (12 mixture
        # inverses and actnorm inverses compound; values reach ~1e7), so the
        # card is held against a float64 run of the same weights, with the
        # CPU's own float32 distance from it as the yardstick.
        ref = copy.deepcopy(cpu).double().sample(8, eps_std=0.0)
        s_card = model.sample(8, eps_std=0.0).cpu().double()
        s_cpu = cpu.sample(8, eps_std=0.0).double()
    rel = lambda s: float((s - ref).abs().max() / ref.abs().max())
    sample_rel, cpu_rel = rel(s_card), rel(s_cpu)
    sample_bar = 10.0 * cpu_rel + 1e-6
    log(f"  encode bits/dim card vs CPU: max diff {bpd_diff:.3g} (bar 1e-3)")
    log(f"  sample(eps_std=0) vs float64 CPU, max abs diff / max abs value "
        f"{float(ref.abs().max()):.3g}: card {sample_rel:.3g}, float32 CPU "
        f"{cpu_rel:.3g} (bar {sample_bar:.3g}, 10x the CPU's)")
    if not bpd_diff <= 1e-3:
        raise AssertionError(f"encode card vs CPU {bpd_diff} > 1e-3")
    if not (torch.isfinite(s_card).all() and sample_rel <= sample_bar):
        raise AssertionError(f"sample card vs float64 {sample_rel} > "
                             f"{sample_bar}")

    round_trip = []
    z = model.dequantize(z.to(device), generator=torch.Generator(
        device=device).manual_seed(7))
    zero = torch.zeros(8, device=device)
    with torch.no_grad():
        for i, level in enumerate(model.levels):
            z, _ = model.squeeze.forward(z, zero)
            y, ld = level(z, zero)
            z_back, ld_back = level.inverse(y, ld)
            round_trip.append(float((z_back - z).abs().max()))
            log(f"  level {i} ({z.shape[1]}x{z.shape[2]}x{z.shape[3]}): K-step "
                f"round trip max abs err {round_trip[-1]:.3g}, log-det "
                f"{float(ld_back.abs().max()):.3g} (bar 1e-3 on z)")
            z = y[:, : y.shape[1] // 2]
    if not max(round_trip) <= 1e-3:
        raise AssertionError(f"round trip {round_trip} > 1e-3")

    train_loss_diff, grad_rel = train_step_card_vs_cpu(
        model, torch.from_numpy(batch[:4]), device, FLAGSHIP, 8)
    return {"encode_bpd_card_vs_cpu": bpd_diff,
            "sample_rel_err_card_vs_float64": sample_rel,
            "round_trip_max_abs_err": round_trip,
            "train_loss_card_vs_cpu": train_loss_diff,
            "train_grad_rel_err_card_vs_cpu": grad_rel}


def train_step_card_vs_cpu(model, x, device, config, noise_seed):
    """One training step at dropout 0 on `model`'s weights (config = the
    model's MarScfConfig keywords), the same images and dequantisation
    noise on the CPU and the card: (loss diff, max gradient diff over the
    largest gradient), held to 1e-4 bits/dim and 1e-3."""
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow

    cfg = MarScfConfig(**{**config, "drop_prob": 0.0})
    noise = torch.rand(x.shape,
                       generator=torch.Generator().manual_seed(noise_seed))
    step = {}
    for dev in ("cpu", device):
        net = MarScfFlow(cfg, device=dev)
        net.load_state_dict(model.state_dict())
        loss = torch.mean(net(x.to(dev), noise=noise.to(dev))[1])
        loss.backward()
        step[str(dev)] = (float(loss.detach()), torch.cat(
            [p.grad.reshape(-1) for p in net.parameters()]).cpu())
        del net
    (loss_cpu, g_cpu), (loss_card, g_card) = step["cpu"], step[str(device)]
    loss_diff = abs(loss_card - loss_cpu)
    grad_scale = float(g_cpu.abs().max())
    grad_rel = float((g_card - g_cpu).abs().max()) / grad_scale
    log(f"  train step at batch {x.shape[0]}, dropout 0: loss card "
        f"{loss_card:.6f} CPU {loss_cpu:.6f} (diff {loss_diff:.3g}, bar 1e-4 "
        f"bits/dim); {g_cpu.numel()} gradients, max abs diff / max abs value "
        f"{grad_scale:.3g}: {grad_rel:.3g} (bar 1e-3)")
    if not (loss_diff <= 1e-4 and grad_rel <= 1e-3
            and torch.isfinite(g_card).all()):
        raise AssertionError(f"train step card vs CPU: loss diff "
                             f"{loss_diff}, gradient {grad_rel}")
    return loss_diff, grad_rel


def timings(model, loader, device, card):
    """Host clock around whole eval and sampling passes (each ends in a
    synchronise: `evaluate` reads every batch's mean back, sampling copies
    the images to the host); the median of 3 runs."""
    from gpnf_tpu_torch.training.loop import evaluate, sample_images

    repeats = 3
    n_images = len(loader) * BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    eval_s, sample_s = [], []
    for i in range(repeats):
        t0 = time.perf_counter()
        evaluate(model, loader,
                 generator=torch.Generator(device=device).manual_seed(9 + i))
        eval_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sample_images(model, BATCH, generator=torch.Generator(
            device=device).manual_seed(20 + i))
        sample_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    out = {"eval_images_per_s": n_images / statistics.median(eval_s),
           "sample_images_per_s": BATCH / statistics.median(sample_s),
           "eval_s": eval_s, "sample_s": sample_s, "peak_memory_bytes": peak}
    log(f"  eval {out['eval_images_per_s']:.1f} images/s (median of "
        f"{repeats} passes over {n_images} images: {eval_s} s) [{card}]")
    log(f"  sample {out['sample_images_per_s']:.1f} images/s (median of "
        f"{repeats} passes of {BATCH} images: {sample_s} s) [{card}]")
    log(f"  peak device memory {peak / 2 ** 30:.3f} GiB [{card}]")
    return out


def flagship_runs(model, loader, device, train_step_fn):
    """One train step, one eval batch and one sampling pass, for profile()."""
    batch = torch.from_numpy(next(iter(loader))).to(device)
    return {"train step": (lambda gen: train_step_fn(), True),
            "eval batch": (lambda gen: model(batch, generator=gen), False),
            "sample pass": (lambda gen: model.sample(BATCH, generator=gen),
                            False)}


def profile(runs, device, card, keep=()):
    """Device time by kernel over each run {label: (fn(generator), grad)},
    after one warm-up call, and the device's busy share of the host-clock
    window (torch.profiler); the twelve kernels that take the most time,
    and every kernel whose name starts with one of `keep`."""
    from gpnf_tpu_torch.utils.cuda_timing import trace

    out = {}
    for label, (fn, grad) in runs.items():
        gen = torch.Generator(device=device).manual_seed(30)
        with torch.set_grad_enabled(grad):
            events, wall_us = trace(lambda: fn(gen))
        by_name = {}
        for name, _, us in events:
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + us, cnt + 1)
        busy_us = sum(tot for tot, _ in by_name.values())
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        top = ranked[:12]
        kept = [kv for kv in ranked[12:] if kv[0].startswith(keep)]
        log(f"  {label}: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%) [{card}]")
        for name, (tot, cnt) in top + kept:
            log(f"    {tot / 1e3:9.3f} ms {100 * tot / max(busy_us, 1e-9):5.1f}% "
                f"x{cnt:<5d} {name}")
        out[label] = {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
                      "top": [[n, t / 1e3, c] for n, (t, c) in top],
                      "kept": [[n, t / 1e3, c] for n, (t, c) in kept]}
    return out


# -- phases 10-12: the flow -> GP head ---------------------------------------------
def _rel(got, want):
    """max |got - want| / max |want|, in float64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def check_gp_kernels(device, timer):
    """Phase 10: the three kernels of the GP path against their plain
    versions, with times, bounds and the backward of each."""
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.utils.cuda_timing import Timer, device_launches

    slow = Timer(device, iters=3, warmup=1)  # the plain versions: thousands
    gen = torch.Generator(device=device).manual_seed(4321)  # of launches each
    results = {}

    def spd(n, dtype):
        x = torch.randn((n, n), generator=gen, device=device,
                        dtype=torch.float64)
        return (x @ x.T / n + torch.eye(n, dtype=torch.float64,
                                        device=device)).to(dtype)

    def record(name, shape, err, ms, plain_ms, library_ms, bytes_moved, ops,
               bf16_ops=0, **extra):
        bound_ms, bound_by = bound(bytes_moved, ops, bf16_ops=bf16_ops)
        row = dict(shape=shape, **extra, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        results.setdefault(name, []).append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        tag = "".join(f" {k} {v}" for k, v in extra.items())
        log(f"  {name} {shape}{tag}: err {err:.3g} | kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library {lib} | bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")

    def check_cholesky(n, dtype):
        a = spd(n, dtype)
        l = kernels.cholesky(a)
        plain = kernels.cholesky_plain(a)
        err, resid = _rel(l, plain), _rel(l @ l.T, a)
        bar = 1e-5 if dtype == torch.float32 else 1e-12
        same = torch.equal(l, kernels.cholesky(a))
        log(f"  cholesky n={n} {dtype}: |L - plain| / max|L| {err:.3g}, "
            f"|L L^T - A| / max|A| {resid:.3g} (bar {bar:g} each), two "
            f"calls bit for bit the same: {same}")
        if not (err <= bar and resid <= bar and same
                and int(torch.count_nonzero(torch.triu(l, 1))) == 0):
            raise AssertionError(f"cholesky n={n} {dtype}: err {err}, "
                                 f"residual {resid}, repeat {same}")
        return a, plain, err, resid

    with torch.no_grad():
        for n, dtype in CHOL_EDGES:
            check_cholesky(n, dtype)
        for n, dtype in CHOL_CASES:
            a, plain, err, resid = check_cholesky(n, dtype)
            size = a.element_size()
            record("cholesky", f"n={n}", err * float(plain.abs().max()),
                   timer(lambda: kernels.cholesky(a)),
                   slow(lambda: kernels.cholesky_plain(a)),
                   timer(lambda: torch.linalg.cholesky_ex(a)),
                   2 * n * n * size, n ** 3 / 3, dtype=str(dtype).removeprefix("torch."), residual=resid)
        for (n, row), dtype in itertools.product(
                CHOL_NAN, (torch.float32, torch.float64)):
            bad = spd(n, dtype)
            bad[row, row] = -1.0
            l_bad = kernels.cholesky(bad)  # raises nothing, reads nothing back
            torch.cuda.synchronize()
            if not (torch.isnan(l_bad).any()
                    and torch.isfinite(l_bad[:row, :row]).all()
                    and int(torch.count_nonzero(torch.triu(l_bad, 1))) == 0):
                raise AssertionError(f"cholesky n={n} {dtype} with a "
                                     f"negative pivot at row {row}: no NaN, "
                                     f"a leading block not finite, or an "
                                     f"upper triangle not zero")
        log(f"  cholesky of a matrix that is not positive definite, pivot at "
            f"(n, row) {CHOL_NAN}, float32 and float64: NaN, no error, the "
            f"leading block finite, the upper triangle zero")
        a = spd(1024, torch.float32)
        want = kernels.cholesky_device_launches(1024)
        launches_1024 = {}
        for mode in ("highest", "high"):
            chol = {k: c for k, c in device_launches(
                lambda: kernels.cholesky(a, mode)).items()
                if k.startswith("chol_")}
            log(f"  device launches of one {mode} factorization at n=1024: "
                f"{sum(chol.values())} {chol} (want {want}: 2 ceil(n/64) - "
                f"1)")
            if sum(chol.values()) != want:
                raise AssertionError(f"cholesky {mode} launched {chol}, want "
                                     f"{want}")
            launches_1024[mode] = {"launches": sum(chol.values()),
                                   "by_kernel": chol}
        results["cholesky_high_trailing"] = check_cholesky_high(
            device, kernels, spd, timer, slow, record)

        solve_launches = {}
        for n in SOLVE_SIZES:
            l = kernels.cholesky(spd(n, torch.float32))
            shapes = [(1, (False, True)), (n, (False, True))]
            if n == 1024:
                shapes.append((POSTERIOR_P, (False,)))
            for p, ways in shapes:
                b = torch.randn((n, p), generator=gen, device=device)
                if p in (1, n):
                    # device launches of one solve, the copy of b left out
                    got = {k: c for k, c in device_launches(
                        lambda: kernels.tril_solve(l, b)).items()
                        if not k.startswith("Memcpy")}
                    want = kernels.tril_solve_device_launches(n, p)
                    log(f"  device launches of one solve at n={n} p={p}: "
                        f"{sum(got.values())} {got} (want {want})")
                    if sum(got.values()) != want:
                        raise AssertionError(f"tril_solve n={n} p={p} "
                                             f"launched {got}, want {want}")
                    solve_launches[f"n={n} p={p}"] = {
                        "launches": sum(got.values()), "by_kernel": got}
                for trans in ways:
                    x = kernels.tril_solve(l, b, trans=trans)
                    plain = kernels.tril_solve_plain(l, b, trans=trans)
                    op = l.T if trans else l
                    err, resid = _rel(x, plain), _rel(op @ x, b)
                    if not (err <= 1e-5 and resid <= 1e-5):
                        raise AssertionError(
                            f"tril_solve n={n} p={p} trans={trans}: err "
                            f"{err}, residual {resid} (bar 1e-5 each)")
                    record("tril_solve", f"n={n} p={p}",
                           err * float(plain.abs().max()),
                           timer(lambda: kernels.tril_solve(l, b, trans=trans)),
                           slow(lambda: kernels.tril_solve_plain(
                               l, b, trans=trans)),
                           timer(lambda: torch.linalg.solve_triangular(
                               op, b, upper=trans)),
                           4 * (n * (n + 1) / 2 + 2 * n * p), n * n * p,
                           trans=trans, residual=resid)

        for bsz, d in AFFINE_SHAPES:
            x2, shift, raw = (torch.randn((bsz, d), generator=gen,
                                          device=device) * s
                              for s in (1.0, 0.1, 1.0))
            got = kernels.fused_affine_forward(x2, shift, raw)
            want = kernels.fused_affine_plain(x2, shift, raw)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            # ldj sums d terms of O(1): held at 1e-5 relative to its scale
            if not (float((got[0] - want[0]).abs().max()) <= 1e-5
                    and _rel(got[1], want[1]) <= 1e-5):
                raise AssertionError(f"fused_affine_forward ({bsz}, {d}): "
                                     f"err {err}")
            record("fused_affine_forward", f"({bsz}, {d})", err,
                   timer(lambda: kernels.fused_affine_forward(x2, shift, raw)),
                   timer(lambda: kernels.fused_affine_plain(x2, shift, raw)),
                   None, 4 * (4 * bsz * d + bsz), AFFINE_OPS * bsz * d)

    # backward of each kernel on the card (float64) against float64 autograd
    # of the plain version on the CPU, n = 256
    n, backward = 256, {}
    b0 = spd(n, torch.float64).cpu()
    cot = torch.randn((n, n), dtype=torch.float64)
    rhs = torch.randn((n, 3), dtype=torch.float64)
    l0 = kernels.cholesky_plain(b0)
    pairs = {"cholesky": (kernels.cholesky, kernels.cholesky_plain),
             "tril_solve": (kernels.tril_solve, kernels.tril_solve_plain),
             "fused_affine_forward": (kernels.fused_affine_forward,
                                      kernels.fused_affine_plain)}
    for name, (kernel, plain) in pairs.items():
        grads = []
        for dev, fn in ((device, kernel), ("cpu", plain)):
            if name == "cholesky":
                b = b0.to(dev).requires_grad_()
                args = (b,)
                loss = (fn(0.5 * (b + b.T)) * cot.to(dev)).sum()
            elif name == "tril_solve":
                args = (l0.to(dev).requires_grad_(), rhs.to(dev).requires_grad_())
                loss = sum((fn(*args, trans=tr) ** 2).sum() for tr in (False, True))
            else:
                args = tuple(t_.clone().to(dev).requires_grad_() for t_ in
                             (cot[:64, :96], cot[64:128, :96],
                              cot[128:192, :96]))
                y, ldj = fn(*args)
                loss = (y * y).sum() + ldj.sum()
            grads.append([torch.tril(g) if name == "tril_solve" and i == 0
                          else g for i, g in enumerate(
                              torch.autograd.grad(loss, args))])
        backward[name] = max(_rel(g, w) for g, w in zip(*grads))
        log(f"  {name} backward on the card (float64) vs CPU float64 autograd "
            f"of the plain version: {backward[name]:.3g} of the largest "
            f"(bar 1e-10)")
        if not backward[name] <= 1e-10:
            raise AssertionError(f"{name} backward: {backward[name]}")
    results["cholesky_device_launches_n1024"] = launches_1024["highest"]
    results["cholesky_high_device_launches_n1024"] = launches_1024["high"]
    results["tril_solve_device_launches"] = solve_launches
    # the drive: one "high" factorization through the public entry at
    # n = 4096, the counts set to 0 just before
    a = spd(4096, torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    l = kernels.cholesky(a, "high")
    torch.cuda.synchronize()
    drive = kernels.launch_counts()
    want = {**dict.fromkeys(drive, 0), "cholesky": 1, "cholesky_high": 1}
    log(f"  drive: cholesky(a, \"high\") at n=4096, launches {drive}")
    if drive != want or not bool(torch.isfinite(l).all()):
        raise AssertionError(f"the high drive launched {drive} (want "
                             f"{want}) or gave a factor not finite")
    results["cholesky_high_drive"] = drive
    return results, backward


def check_cholesky_high(device, kernels, spd, timer, slow, record):
    """Phase 10's trailing_precision="high": the kernel against plain "high"
    (1e-5 relative to max |L|, and by the residual), two calls bit for bit,
    the factor not "highest"'s; timed at CHOL_HIGH_CASES beside "highest"
    on the same matrix and cholesky_ex, the bound the bf16x3 products at
    the bf16 rate (three each) and the rest at the fp32 rate
    (`cholesky_high_flops`); checked at CHOL_HIGH_EDGES; NaN without an
    error where a pivot is negative; the trailing kernel alone
    (`trailing_high`) against its plain version within its float32 sums'
    spread. Returns the trailing checks' readings."""
    ch = importlib.import_module("gpnf_tpu_torch.ops.kernels.cholesky")

    def check(n, p, dtype):
        a = spd(n, dtype)
        l = kernels.cholesky(a, "high", p)
        plain = kernels.cholesky_plain(a, "high", p)
        err, resid = _rel(l, plain), _rel(l @ l.T, a)
        same = torch.equal(l, kernels.cholesky(a, "high", p))
        highest = kernels.cholesky(a)
        # from n = 2 P many products cross a P-block: not "highest"'s bits
        crosses = n >= 2 * p
        log(f"  cholesky high n={n} P={p} {dtype}: |L - plain| / max|L| "
            f"{err:.3g}, |L L^T - A| / max|A| {resid:.3g} (bar 1e-5 each), "
            f"two calls bit for bit the same: {same}, |L - highest| / "
            f"max|L| {_rel(l, highest):.3g}")
        if not (err <= 1e-5 and resid <= 1e-5 and same
                and not (crosses and torch.equal(l, highest))
                and int(torch.count_nonzero(torch.triu(l, 1))) == 0):
            raise AssertionError(f"cholesky high n={n} P={p} {dtype}: err "
                                 f"{err}, residual {resid}, repeat {same}, "
                                 f"or the factor is highest's")
        return a, plain, err, resid

    for i, (n, p) in enumerate(CHOL_HIGH_EDGES):
        check(n, p, torch.float32 if i < len(CHOL_HIGH_EDGES) - 2
              else torch.float64)
    for n, dtype in CHOL_HIGH_CASES:
        p = ch.hbm_panel_width(n)
        a, plain, err, resid = check(n, p, dtype)
        cross, other = ch.cholesky_high_flops(n, p)
        record("cholesky_high", f"n={n}", err * float(plain.abs().max()),
               timer(lambda: kernels.cholesky(a, "high")),
               slow(lambda: kernels.cholesky_plain(a, "high")),
               timer(lambda: torch.linalg.cholesky_ex(a)),
               2 * n * n * a.element_size(), other, bf16_ops=3 * cross,
               dtype=str(dtype).removeprefix("torch."), panel_width=p,
               residual=resid, highest_ms=timer(lambda: kernels.cholesky(a)),
               bf16x3_share=cross / (n ** 3 / 3))
    for n, row in ((512, 300), (200, 195)):
        bad = spd(n, torch.float32)
        bad[row, row] = -1.0
        l_bad = kernels.cholesky(bad, "high", 64)  # raises nothing
        torch.cuda.synchronize()
        if not (torch.isnan(l_bad).any()
                and torch.isfinite(l_bad[:row, :row]).all()):
            raise AssertionError(f"cholesky high n={n}, negative pivot at "
                                 f"row {row}: no NaN or a leading block not "
                                 f"finite")
    log("  cholesky high of a matrix that is not positive definite: NaN, no "
        "error, the leading block finite")
    readings = []
    for (n, p, j), dtype in itertools.product(
            CHOL_TRAILING, (torch.float32, torch.float64)):
        gen = torch.Generator(device=device).manual_seed(n + j)
        a = (10 * torch.eye(n, device=device, dtype=torch.float64)
             + 0.1 * torch.randn((n, n), generator=gen, device=device,
                                 dtype=torch.float64)).to(dtype)
        got, want = ch.trailing_high(a, j, p), ch.trailing_high_plain(a, j, p)
        s = 64 * (j + 1)
        e = min(n, s + 64)
        panel = a[:, s - 64:s].double().abs()
        spread = 2 * 64 * 2.0 ** -24 * (panel @ panel.T) + 2.0 ** -23 * (
            want.double().abs())
        lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device))
        lower[:s] = False
        lower[:, :s] = False
        lower[s:e, s:e] = False
        diff = (got.double() - want.double()).abs()
        share = float((diff[lower] / spread[lower]).max())
        tile = _rel(torch.tril(got[s:e, s:e]), torch.tril(want[s:e, s:e]))
        log(f"  trailing kernel alone, n={n} P={p} panel {j} {dtype}: max "
            f"|got - plain| / spread {share:.3g} (bar 1), the factored tile "
            f"{tile:.3g} (bar 1e-5)")
        if not (share <= 1.0 and tile <= 1e-5
                and torch.equal(got[:s], a[:s])):
            raise AssertionError(f"trailing kernel n={n} P={p} j={j} "
                                 f"{dtype}: {share} of the spread, tile "
                                 f"{tile}")
        readings.append(dict(n=n, panel_width=p, panel=j,
                             dtype=str(dtype).removeprefix("torch."),
                             max_err_over_spread=share, tile_rel_err=tile))
    return readings


def gp_run(device, card):
    """Phase 11: the titular `train_gp --flow` run and the tabular mode, the
    launches of one joint NLML + gradient, then the card against the CPU on
    the same weights."""
    import numpy as np

    from gpnf_tpu_torch import bench_flow_gp, train_gp
    from gpnf_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    out = train_gp.main(GP_RUN)
    tab = train_gp.main(["--device", "cuda"])
    counts = kernels.launch_counts()
    log(f"  launches on the whole GP path {counts}; per joint fit step on "
        f"average {out['joint']['launches_per_step']}")
    if counts["cholesky_high"]:
        raise AssertionError(f"the GP path launched the Cholesky's \"high\" "
                             f"mode: {counts}")
    if any(counts[k] for k in counts if k not in GP_KERNELS):
        raise AssertionError(f"the GP path launched a flagship kernel: {counts}")
    fgp, x, y = bench_flow_gp.build(1024, device, np.random.default_rng(0))
    kernels.reset_launch_counts()
    bench_flow_gp.nlml_and_grad(fgp, x, y)
    per_step = kernels.launch_counts()
    want = {**dict.fromkeys(per_step, 0), **GP_PER_STEP}
    log(f"  launches of one joint NLML + gradient at n=1024 {per_step} (want "
        f"{want})")
    if per_step != want:
        raise AssertionError(f"joint NLML + gradient launches {per_step}")
    del fgp, x, y
    runs = {m: out[m] for m in ("raw", "frozen", "joint")}
    runs["tabular"] = tab
    for mode, r in runs.items():
        losses = r["losses"]
        log(f"  {mode}: NLML {r['nlml_start']:.4f} -> {r['nlml_end']:.4f}, "
            f"test RMSE {r['rmse']:.4f}, fit {r['fit_s']:.2f} s "
            f"({len(losses) / r['fit_s']:.1f} steps/s), min posterior var "
            f"{r['min_var']:.3g} [{card}]")
        if not (all(math.isfinite(v) for v in losses)
                and r["nlml_end"] < r["nlml_start"] and r["min_var"] > 0):
            raise AssertionError(f"{mode}: NLML not finite and falling, or a "
                                 f"variance <= 0: {r['nlml_start']} -> "
                                 f"{r['nlml_end']}, {r['min_var']}")
    pre = out["pretrain_losses"]
    log(f"  pretrain bits/dim {pre[0]:.4f} -> {pre[-1]:.4f} over {len(pre)} "
        f"steps")
    if not out["joint"]["nlml_end"] < out["frozen"]["nlml_end"]:
        raise AssertionError("the joint fit did not end below the frozen one")
    checks = {m: card_vs_cpu_gp(out[m]["model"], device, m)
              for m in ("frozen", "joint")}
    return out, tab, counts, checks


def _joint_nlml_grads(fgp, flat, imgs, y, dev, dtype, relu=None):
    """(NLML, {parameter name: its gradient}, the model) of a copy of `fgp`
    on `dev` in `dtype`, its weights carried through convert.py.

    `relu` = ("record", signs) appends the sign of every input to the
    couplings' ReLUs (the outputs of NNNet.conv1 and conv2) to `signs`;
    ("apply", signs) gives each such input that lies on the other side a
    value of +-1e-30 with an unchanged gradient, so that this run takes the
    recorded pieces of the piecewise-linear flow, and returns how many
    moved."""
    from gpnf_tpu_torch import convert, train_gp
    from gpnf_tpu_torch.models.gp import FlowGP, GPConfig, GPRegression
    from gpnf_tpu_torch.ops.coupling import NNNet

    port = FlowGP(train_gp.build_flow(train_gp.parse_args(GP_RUN), dev),
                  GPRegression(GPConfig(ard=False), fgp.gp.input_dim,
                               device=dev)).to(dtype)
    convert.load_jax_params(port, flat, dtype=None)
    moved = [0]
    if relu is not None:
        how, signs = relu
        todo = iter(signs)

        def hook(mod, inp, out):
            if how == "record":
                signs.append((out > 0).cpu())
                return None
            want = next(todo).to(out.device)
            other = want != (out > 0)
            moved[0] += int(other.sum())
            tiny = torch.where(want, 1e-30, -1e-30).to(out.dtype)
            return out + torch.where(other, tiny - out, 0.0).detach()

        for net in port.flow.modules():
            if isinstance(net, NNNet):
                net.conv1.register_forward_hook(hook)
                net.conv2.register_forward_hook(hook)
    loss = port.joint_nlml(torch.from_numpy(imgs).to(dev, dtype),
                           torch.from_numpy(y).to(dev, dtype))
    loss.backward()
    return float(loss.detach()), {
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        .reshape(-1).double().cpu() for k, p in port.named_parameters()}, \
        port, moved[0]


def card_vs_cpu_gp(fgp, device, mode, n=128):
    """The joint NLML and every gradient at n new images, on the card and on
    the CPU, with the weights of the `mode` fit.

    Float64: card within 1e-10 of the CPU (NLML relative to max(1, |NLML|),
    gradients of the largest). Float32 is held against float64 on the CPU
    taking the card's ReLU pieces: the flow is piecewise linear, and a ReLU
    input within float32 rounding of 0 moves a gradient by up to 1e-2 of
    the largest on whichever side rounds it across. Frozen model (its Gram
    conditioned near 2e3): NLML within 1e-4, gradients within 1e-3. The
    joint fit drives the noise down until that Gram is conditioned near
    2e5, where two float32 implementations land 1e-4 to 1e-2 from float64
    and either may be the closer, so there each of the card's two
    distances must be within 3x the float32 CPU's (on the same pieces) or
    within cond x 2^-24, the first-order float32 error of a solve."""
    from gpnf_tpu_torch import convert, train_gp

    imgs, y = train_gp.make_image_regression(n, 16, 0.1, seed=7)
    flat = convert.state_dict_to_jax(fgp.state_dict())
    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    run = lambda dev, dtype, relu=None: _joint_nlml_grads(
        fgp, flat, imgs, y, dev, dtype, relu)
    signs = []
    card32 = run(device, f32, ("record", signs))
    cpu32, ref = (run(cpu, dtype, ("apply", signs)) for dtype in (f32, f64))
    card64, cpu64 = run(device, f64), run(cpu, f64)
    with torch.no_grad():
        port = cpu64[2]
        z = port.feature_fn(torch.from_numpy(imgs).double())
        ev = torch.linalg.eigvalsh(port.gp.gram(z) + (
            torch.exp(port.gp.log_noise) + 1e-6) * torch.eye(n).double())
    out = {"gram_condition": float(ev[-1] / ev[0]),
           "relu_inputs_moved": {"cpu_float32": cpu32[3],
                                 "cpu_float64": ref[3]}}
    log(f"  {mode} weights: the Gram's condition number at n={n}: "
        f"{out['gram_condition']:.4g}; ReLU inputs on the other side of the "
        f"card's: CPU float32 {cpu32[3]}, CPU float64 {ref[3]}")

    def dist(a, b):
        """|NLML a - b| relative to max(1, |NLML b|), max |grad a - grad b|
        over max |grad b|, and the parameter where the latter peaks."""
        (va, ga, *_), (vb, gb, *_) = a, b
        worst = {k: float((ga[k] - gb[k]).abs().max()) for k in gb}
        top = max(worst, key=worst.get)
        scale = max(float(g.abs().max()) for g in gb.values())
        return abs(va - vb) / max(1.0, abs(vb)), worst[top] / scale, top

    failed = [f"{name}: a gradient is not finite"
              for name, r in (("float32", card32), ("float64", card64))
              if not all(torch.isfinite(g).all() for g in r[1].values())]
    d64, d_card, d_cpu = dist(card64, cpu64), dist(card32, ref), dist(cpu32,
                                                                      ref)
    out.update(float64=d64, float32_from_float64={"card": d_card,
                                                  "cpu": d_cpu})
    log(f"  {mode} weights, n={n}, card vs CPU in float64: NLML {d64[0]:.3g}, "
        f"{sum(g.numel() for g in cpu64[1].values())} gradients "
        f"{d64[1]:.3g} of the largest ({d64[2]}) (bar 1e-10 each)")
    log(f"  {mode} weights, float32 from float64 on the card's ReLU pieces "
        f"(NLML, gradients): card {d_card[0]:.3g} / {d_card[1]:.3g} "
        f"({d_card[2]}), CPU {d_cpu[0]:.3g} / {d_cpu[1]:.3g} ({d_cpu[2]})")
    if not (d64[0] <= 1e-10 and d64[1] <= 1e-10):
        failed.append(f"float64 card vs CPU {d64}")
    if mode == "frozen" and not (d_card[0] <= 1e-4 and d_card[1] <= 1e-3):
        failed.append(f"float32 card from float64 {d_card} (bars 1e-4, 1e-3)")
    first_order = out["gram_condition"] * 2.0 ** -24
    if mode == "joint" and not all(c <= max(3 * r, first_order) for c, r in
                                   zip(d_card[:2], d_cpu[:2])):
        failed.append(f"float32 card from float64 {d_card}: above 3x the "
                      f"float32 CPU's {d_cpu} and cond x 2^-24 "
                      f"{first_order:.3g}")
    if failed:
        raise AssertionError(f"{mode} weights: " + "; ".join(failed))
    return out


def gp_timings(device, card, out, with_profile):
    """Phase 12: the bench's joint NLML + gradient, the joint fit's steps/s;
    with --profile, device time by kernel over one joint NLML + gradient at
    n = 1024 and 4096."""
    import numpy as np

    from gpnf_tpu_torch import bench_flow_gp

    rng = np.random.default_rng(0)
    rows = []
    for n in BENCH_SIZES:
        rows.append(bench_flow_gp.measure(n, device, rng, reps=10))
        log(f"  joint NLML + gradient n={n}: {rows[-1]['ms']:.3f} ms, peak "
            f"{rows[-1]['peak_memory_bytes'] / 2 ** 30:.3f} GiB, value "
            f"{rows[-1]['value_check']:.4f} [{card}]")
    joint = out["joint"]
    steps_per_s = len(joint["losses"]) / joint["fit_s"]
    log(f"  joint fit at n=1024: {steps_per_s:.2f} steps/s [{card}]")
    result = {"bench": rows, "joint_fit_steps_per_s": steps_per_s}
    if with_profile:
        runs = {}
        for n in (1024, 4096):
            fgp, x, y = bench_flow_gp.build(n, device, rng)
            runs[f"joint NLML + gradient n={n}"] = (
                lambda gen, f=fgp, x=x, y=y: bench_flow_gp.nlml_and_grad(
                    f, x, y), True)
        result["profile"] = profile(runs, device, card, keep=("chol_",))
    return result


# -- phases 13-15: the ImageNet-64 row ----------------------------------------------
def check_long_kernels(device, timer, w, heads):
    """Phase 13: the long-sequence attention kernels against their plain
    versions on qkv = seq w^T (w of the 64-px model's level 0), with times,
    bounds and the library's (SDPA, rate 0) times."""
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.ops.kernels.fused_attention import MAX_S_LONG

    gen = torch.Generator(device=device).manual_seed(5678)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    c = w.shape[1]
    dh = c // heads
    results = {}

    def record(name, batch, s, rate, err, ms, plain_ms, library_ms,
               forward):
        scores = batch * heads * s * s
        core = 2 * scores * dh  # one S x S x Dh product
        rows = batch * s
        # on the tensor cores: qkv in, out, two products and the softmax
        # forward; qkv and g in, dqkv out, five products and dS backward
        if forward:
            bytes_moved, ops = 4 * (rows * 3 * c + rows * c), 2 * core
        else:
            bytes_moved, ops = 4 * (2 * rows * 3 * c + rows * c), 5 * core
        bound_ms, bound_by, extra, fp32 = tensor_core_bound(
            bytes_moved, ops + 5 * scores)
        row = dict(batch=batch, s=s, rate=rate,
                   max_abs_err=None if err is None else err[0],
                   max_rel_err=None if err is None else err[1], ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, **extra)
        results.setdefault(name, []).append(row)
        ms_or_na = lambda v: "n/a" if v is None else f"{v:.4f} ms"
        log(f"  {name} B={batch} S={s} rate {rate}: max abs err "
            f"{'n/a' if err is None else f'{err[0]:.3g}'} | kernel {ms:.4f} "
            f"ms plain {ms_or_na(plain_ms)} library {ms_or_na(library_ms)} | "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}{fp32})")

    def sdpa_inputs(qkv, grad):
        b, s, _ = qkv.shape
        k, v, q = (t_.reshape(b, s, heads, dh).transpose(1, 2).contiguous()
                   .requires_grad_(grad) for t_ in qkv.split(c, dim=-1))
        return q, k, v

    def library_fwd_ms(qkv):
        q, k, v = sdpa_inputs(qkv, False)
        return timer(lambda: F.scaled_dot_product_attention(q, k, v))

    def library_bwd_ms(qkv, g):
        """Autograd backward of SDPA, the graph built once and its backward
        timed alone."""
        b, s, _ = qkv.shape
        q, k, v = sdpa_inputs(qkv, True)
        g4 = g.reshape(b, s, heads, dh).transpose(1, 2)
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), g4,
                                                 retain_graph=True))

    with torch.no_grad():
        for batch, s in LONG_CASES:
            qkv = torch.matmul(randn(batch, s, c) * 0.5, w.t())
            g = randn(batch, s, c)
            seed = torch.tensor([8765 + s], dtype=torch.int32, device=device)
            for rate in (0.0, RATE):
                # one seed for kernel and plain version: the same mask
                fwd = lambda x: kernels.attention_long_qkv(x, heads, rate,
                                                           seed)
                bwd = lambda x, y: kernels.attention_long_qkv_bwd(
                    x, y, heads, rate, seed)
                nb = batch if rate == 0.0 else min(batch, LONG_DROPOUT_BATCH)
                sub, g_sub = qkv[:nb], g[:nb]
                plain = lambda: kernels.attention_long_plain(sub, heads, rate,
                                                             seed)
                err = max_errs(fwd(sub), plain())
                if err[0] > 1e-5:
                    raise AssertionError(f"long attention B={nb} S={s} rate "
                                         f"{rate}: max abs err {err[0]} > 1e-5")
                record("fused_attention_long", nb, s, rate, err,
                       timer(lambda: fwd(sub)), timer(plain),
                       library_fwd_ms(sub) if rate == 0.0 else None, True)
                plain_b = lambda: kernels.attention_long_plain_bwd(
                    sub, g_sub, heads, rate, seed)
                got, again, want = bwd(sub, g_sub), bwd(sub, g_sub), plain_b()
                if not torch.equal(got, again):
                    raise AssertionError(f"long attention bwd B={nb} S={s} "
                                         f"rate {rate}: two calls differ")
                scale = float(want.abs().max())
                over_scale = float((got - want).abs().max()) / scale
                if not over_scale <= 1e-4:
                    raise AssertionError(
                        f"long attention bwd B={nb} S={s} rate {rate}: dqkv "
                        f"max abs err / max |plain| = {over_scale} > 1e-4")
                record("fused_attention_long_bwd", nb, s, rate,
                       max_errs(got, want), timer(lambda: bwd(sub, g_sub)),
                       timer(plain_b),
                       library_bwd_ms(sub, g_sub) if rate == 0.0 else None,
                       False)
                results["fused_attention_long_bwd"][-1].update(
                    deterministic=True,
                    err_over_scale=float(f"{over_scale:.3g}"))
                if nb < batch:  # the kernels alone at the path's batch
                    record("fused_attention_long", batch, s, rate, None,
                           timer(lambda: fwd(qkv)), None, None, True)
                    record("fused_attention_long_bwd", batch, s, rate, None,
                           timer(lambda: bwd(qkv, g)), None, None, False)
        # past the kernels' int indices (on the meta device: checked first)
        too_long = torch.zeros((1, MAX_S_LONG + 1, 3 * c), device="meta")
        try:
            kernels.attention_long_qkv(too_long, heads)
        except ValueError as e:
            log(f"  S = {too_long.shape[1]} refused: {e}")
        else:
            raise AssertionError(f"the long attention took S > {MAX_S_LONG}")
    return results


def imagenet64_row(model, device, out_dir, seed, card, with_profile):
    """Phase 14: the 64-px row through the port's trainer and server."""
    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import (evaluate, sample_images,
                                              save_sample_grid, train_step)
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    train_loader, test_loader, shape = get_dataset("imagenet_64", BATCH,
                                                   seed=seed)
    log(f"  imagenet_64: {train_loader.images.shape[0]} training and "
        f"{test_loader.images.shape[0]} test images of {shape} (the "
        f"synthetic set: no ImageNet-64 files in the checkout)")
    batches = [torch.from_numpy(b).to(device)
               for b, _ in zip(train_loader, range(8))]
    gen = torch.Generator(device=device).manual_seed(seed + 41)
    model.ddi(batches[0], generator=gen)
    model.train()
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=WARM_UP,
                       batch_size=BATCH)
    step = 0

    def one_step():
        nonlocal step
        loss = train_step(model, opt, batches[step % len(batches)], gen)
        step += 1
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(TRAIN64_STEPS)]
    counts = kernels.launch_counts()
    per_step = {k: v / TRAIN64_STEPS for k, v in counts.items()}
    log(f"  {TRAIN64_STEPS} steps at batch {BATCH}, dropout {RATE}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} bits/dim; launches per step "
        f"{per_step}")
    log(f"  losses {[round(x, 4) for x in losses]}")
    if per_step != PER_STEP_64:
        raise AssertionError(f"64-px train launches per step {per_step} != "
                             f"{PER_STEP_64}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"64-px train losses not finite and falling: "
                             f"{losses}")
    if opt.total_notfinite:
        raise AssertionError(f"{opt.total_notfinite} non-finite updates")
    window_s = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW64_STEPS):
            loss = one_step()
        float(loss)
        window_s.append(time.perf_counter() - t0)
    train_ips = WINDOW64_STEPS * BATCH / statistics.median(window_s)
    train_peak = torch.cuda.max_memory_allocated(device)
    log(f"  train {train_ips:.2f} images/s (median of {WINDOWS} windows of "
        f"{WINDOW64_STEPS} steps at batch {BATCH}: {window_s} s) [{card}]")
    log(f"  train peak device memory {train_peak / 2 ** 30:.3f} GiB at batch "
        f"{BATCH} [{card}]")

    model.eval()
    loader = NumpyLoader(test_loader.images[:2 * BATCH], BATCH, shuffle=False)
    egen = lambda k: torch.Generator(device=device).manual_seed(seed + k)
    kernels.reset_launch_counts()
    nll = evaluate(model, loader, generator=egen(42))
    eval_counts = kernels.launch_counts()
    want = {k: EVAL_64.get(k, 0) * len(loader) for k in eval_counts}
    log(f"  eval bits/dim {nll:.4f} over {len(loader)} batches of {BATCH}; "
        f"launches {eval_counts}")
    if eval_counts != want:
        raise AssertionError(f"64-px eval launches {eval_counts} != {want}")
    if not (math.isfinite(nll) and nll < 30.0):
        raise AssertionError(f"64-px eval bits/dim {nll} not finite and < 30")

    kernels.reset_launch_counts()
    path, nan_count = save_sample_grid(
        model, os.path.join(out_dir, "samples64.png"), n=BATCH,
        generator=egen(43))
    sample_counts = kernels.launch_counts()
    want = {k: SAMPLE_64.get(k, 0) for k in sample_counts}
    log(f"  wrote {path} ({os.path.getsize(path)} bytes); {nan_count} NaN "
        f"before the clamp; launches {sample_counts}")
    if sample_counts != want:
        raise AssertionError(f"64-px sampling launches {sample_counts} != "
                             f"{want}")
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{path} is not a PNG")

    eval_s, sample_s = [], []
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(3):
        t0 = time.perf_counter()
        evaluate(model, loader, generator=egen(50 + i))
        eval_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sample_images(model, BATCH, generator=egen(60 + i))
        sample_s.append(time.perf_counter() - t0)
    serve_peak = torch.cuda.max_memory_allocated(device)
    eval_ips = len(loader) * BATCH / statistics.median(eval_s)
    sample_ips = BATCH / statistics.median(sample_s)
    log(f"  eval {eval_ips:.2f} images/s (median of 3 passes over "
        f"{len(loader) * BATCH} images: {eval_s} s) [{card}]")
    log(f"  sample {sample_ips:.2f} images/s (median of 3 passes of {BATCH} "
        f"images: {sample_s} s); serving peak {serve_peak / 2 ** 30:.3f} GiB "
        f"[{card}]")
    out = {"losses": losses, "launches": counts, "launches_per_step": per_step,
           "train_images_per_s": train_ips, "train_window_s": window_s,
           "train_peak_memory_bytes": train_peak, "eval_bits_per_dim": nll,
           "eval_launches": eval_counts, "sample_launches": sample_counts,
           "nan_before_clamp": nan_count, "eval_images_per_s": eval_ips,
           "sample_images_per_s": sample_ips, "eval_s": eval_s,
           "sample_s": sample_s, "serve_peak_memory_bytes": serve_peak}
    if with_profile:
        batch = batches[0]
        model.train()
        runs = {"64-px train step": (lambda g_: one_step(), True)}
        out["profile"] = profile(runs, device, card)
        model.eval()
        out["profile"].update(profile({
            "64-px eval batch": (lambda g_: model(batch, generator=g_), False),
            "64-px sample pass": (lambda g_: model.sample(BATCH, generator=g_),
                                  False)}, device, card))
    return out, batches[0][:2].cpu()


def encode_and_step_card_vs_cpu(model, x, device, config, noise_seed):
    """Phases 15 and 16: encode bits/dim (eval mode) and one training step
    at dropout 0 on `model`'s weights and the images x, card against CPU."""
    model.eval()
    cpu = copy.deepcopy(model).to("cpu")
    logdet = torch.zeros(x.shape[0])
    scale = math.log(2.0) * model.num_dims
    with torch.no_grad():
        _, obj_card = model.encode(x.to(device), logdet.to(device))
        _, obj_cpu = cpu.encode(x, logdet)
    bpd_diff = float((obj_card.cpu() - obj_cpu).abs().max()) / scale
    log(f"  encode bits/dim card vs CPU: max diff {bpd_diff:.3g} (bar 1e-3)")
    if not bpd_diff <= 1e-3:
        raise AssertionError(f"encode card vs CPU {bpd_diff} > 1e-3")
    del cpu
    loss_diff, grad_rel = train_step_card_vs_cpu(model, x, device, config,
                                                 noise_seed)
    return {"encode_bpd_card_vs_cpu": bpd_diff,
            "train_loss_card_vs_cpu": loss_diff,
            "train_grad_rel_err_card_vs_cpu": grad_rel}


# -- phase 16: the fused GatedConv (MarScfConfig.fused_gated_conv) -------------------
# (H, W) of every GatedConv at the 32-px levels 0 / 1 / 2 and the 64-px level 0
GCONV_SHAPES = ((16, 16), (8, 8), (4, 4), (32, 32))
FGC_PER_PASS = 120  # L * K * num_blocks gated convs a forward
# (C, H, W) of the other widths, at phase 18's batch: checked at rate 0 and
# 0.2, timed at C = 512 on 16 x 16 (the CLIs' width at the 32-px level 0)
GCONV_WIDTHS = ((12, 16, 16), (12, 4, 4), (48, 16, 16), (48, 4, 4),
                (160, 16, 16), (160, 4, 4), (512, 16, 16), (512, 8, 8),
                (512, 4, 4))
C512_FGC_STEPS = 3  # train steps of the --C 512 model with the flag
# the flagship with the flag: train steps before one timed window (phase 4
# takes 20, then three)
FGC_TRAIN_STEPS = 10


def _gated_conv_checks(kernels, wts, g, rate, seed, tag):
    """Forward within 1e-5 x max(1, max |out|) of the plain version, dx
    within 1e-5 and each weight gradient within 1e-4 of its largest, two
    calls of each bit for bit; (forward err, backward errs, backward err /
    max |plain|)."""
    names = ("dx", "dw1", "db1", "dwg", "dbg")
    with torch.no_grad():
        out = kernels.fused_gated_conv(*wts, rate, seed)
        out_again = kernels.fused_gated_conv(*wts, rate, seed)
        want = kernels.gated_conv_plain(*wts, rate, seed)
        got = kernels.fused_gated_conv_bwd(*wts, g, rate, seed)
        again = kernels.fused_gated_conv_bwd(*wts, g, rate, seed)
        want_b = kernels.gated_conv_plain_bwd(*wts, g, rate, seed)
    fwd_err = float((out - want).abs().max())
    fwd_bar = 1e-5 * max(1.0, float(want.abs().max()))
    over = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(names, got, want_b)}
    log(f"  {tag}: forward max abs err {fwd_err:.3g} (bar {fwd_bar:.3g}); "
        f"backward max abs err / max |plain| "
        + ", ".join(f"{n} {v:.3g}" for n, v in over.items())
        + " (bars dx 1e-5, weights 1e-4)")
    if not fwd_err <= fwd_bar:
        raise AssertionError(f"{tag}: forward err {fwd_err}")
    if not (torch.equal(out, out_again) and all(
            torch.equal(a, b) for a, b in zip(got, again))):
        raise AssertionError(f"{tag}: two calls differ")
    if not (over["dx"] <= 1e-5 and all(over[n] <= 1e-4 for n in names[1:])):
        raise AssertionError(f"{tag}: backward {over}")
    return fwd_err, max(float((a - b).abs().max())
                        for a, b in zip(got, want_b)), over


def _gated_conv_launches(kernels, wts, g, rate, seed, tag):
    """Device launches of one forward and one backward call (the kernel
    nodes of a CUDA graph that captures it), held to the source's count
    (`gated_conv_plan`)."""
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    fgc = importlib.import_module(
        "gpnf_tpu_torch.ops.kernels.fused_gated_conv")
    b, h, w, c = wts[0].shape
    got = []
    with torch.no_grad():
        for backward, call in (
                (False, lambda: kernels.fused_gated_conv(*wts, rate, seed)),
                (True, lambda: kernels.fused_gated_conv_bwd(*wts, g, rate,
                                                            seed))):
            want = fgc.gated_conv_plan(b, h, w, c, rate > 0.0, backward)[1]
            n = graph_launches(call)
            if n != want:
                raise AssertionError(f"{tag}: {n} device launches a "
                                     f"{'backward' if backward else 'forward'}"
                                     f" call, want {want}")
            got.append(n)
    log(f"  {tag}: device launches a call: forward {got[0]}, backward "
        f"{got[1]}")
    return {"fwd": got[0], "bwd": got[1]}


def _gated_conv_bound(pixels, c, backward):
    """The bound of one call (3xTF32 on the tensor cores; fp32 beside it)
    on the bytes and FLOP of `gated_conv_work`."""
    fgc = importlib.import_module(
        "gpnf_tpu_torch.ops.kernels.fused_gated_conv")
    return tensor_core_bound(*fgc.gated_conv_work(pixels, c, backward))


def check_gated_conv_kernels(device, timer, gconv):
    """Phase 16: the gated-conv kernels against their plain versions at batch
    64 and every level's shape, rate 0 and 0.2 (one seed: the same mask),
    two calls of each bit for bit the same, the device launches of a call,
    float64 refused; then at the other widths (GCONV_WIDTHS, batch 16).
    Times: each kernel, its plain version, the port's unfused chain (the
    GatedConv module + x in NCHW: two cuDNN convs and ATen, the default
    path) forward and forward + backward, and the fused module (weight norm
    + kernels) forward + backward; no single PyTorch call computes the
    block, so there is no library time."""
    from gpnf_tpu_torch.ops import kernels

    gen = torch.Generator(device=device).manual_seed(2468)
    c = gconv.conv.b.shape[0]
    with torch.no_grad():
        w1 = gconv.conv.effective_weight().permute(2, 3, 1, 0).contiguous()
        wg = gconv.gate.effective_weight()[:, :, 0, 0].t().contiguous()
    b1, bg = gconv.conv.b.detach(), gconv.gate.b.detach()
    params = list(gconv.parameters())
    results = {name: [] for name in FGC}
    for h, w in GCONV_SHAPES:
        x = torch.randn((BATCH, h, w, c), generator=gen, device=device)
        g = torch.randn((BATCH, h, w, c), generator=gen, device=device)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        g_nchw = g.permute(0, 3, 1, 2).contiguous()
        seed = torch.tensor([1357 + h], dtype=torch.int32, device=device)
        pixels = BATCH * h * w
        for rate in (0.0, RATE):
            wts = (x, w1, b1, wg, bg)
            tag = f"gated conv {h}x{w} rate {rate}"
            fwd_err, bwd_err, over = _gated_conv_checks(kernels, wts, g, rate,
                                                        seed, tag)
            launches = _gated_conv_launches(kernels, wts, g, rate, seed, tag)
            with torch.no_grad():
                ms = timer(lambda: kernels.fused_gated_conv(*wts, rate, seed))
                bwd_ms = timer(lambda: kernels.fused_gated_conv_bwd(
                    *wts, g, rate, seed))
                plain_ms = timer(lambda: kernels.gated_conv_plain(
                    *wts, rate, seed))
                plain_bwd_ms = timer(lambda: kernels.gated_conv_plain_bwd(
                    *wts, g, rate, seed))
            gconv.train(rate > 0.0)  # the module's own Dropout2d
            chain = lambda xx: gconv(xx) + xx
            with torch.no_grad():
                unfused_ms = timer(lambda: chain(x_nchw))
            xr, xr_nchw = (t_.clone().requires_grad_() for t_ in (x, x_nchw))
            unfused_fb_ms = timer(lambda: torch.autograd.grad(
                chain(xr_nchw), [xr_nchw] + params, g_nchw))
            fused_fb_ms = timer(lambda: torch.autograd.grad(
                gconv.apply_fused(xr), [xr] + params, g))
            gconv.eval()
            common = dict(shape=f"{h}x{w}", batch=BATCH, c=c, rate=rate,
                          library_ms=None, unfused_fwd_ms=unfused_ms,
                          unfused_fwd_bwd_ms=unfused_fb_ms,
                          fused_module_fwd_bwd_ms=fused_fb_ms)
            notes = []
            for name, kernel_ms, p_ms, backward, err in (
                    ("fused_gated_conv", ms, plain_ms, False, fwd_err),
                    ("fused_gated_conv_bwd", bwd_ms, plain_bwd_ms, True,
                     bwd_err)):
                bound_ms, bound_by, fp32, note = _gated_conv_bound(
                    pixels, c, backward)
                notes.append(f"{bound_ms * 1e3:.2f}{note}")
                results[name].append(dict(
                    common, max_abs_err=err, ms=kernel_ms, plain_ms=p_ms,
                    bound_ms=bound_ms, bound_by=bound_by, **fp32,
                    device_launches=launches["bwd" if backward else "fwd"]))
                if backward:
                    results[name][-1].update(deterministic=True,
                                             err_over_scale=over)
            log(f"  {tag}: kernel fwd {ms:.4f} ms bwd {bwd_ms:.4f} ms | plain "
                f"fwd {plain_ms:.4f} bwd {plain_bwd_ms:.4f} ms | unfused "
                f"chain fwd {unfused_ms:.4f} ms fwd+bwd {unfused_fb_ms:.4f} ms"
                f" | fused module fwd+bwd {fused_fb_ms:.4f} ms | bounds "
                f"{notes[0]} / {notes[1]} us (3xTF32, operations)")
    x = torch.zeros((2, 4, 4, c), device=device)
    try:
        kernels.fused_gated_conv(*(t_.double() for t_ in (x, w1, b1, wg, bg)))
    except TypeError as e:
        log(f"  float64 refused before the device: {e}")
    else:
        raise AssertionError("the gated-conv kernel took float64")
    for cw, h, w in GCONV_WIDTHS:
        r = lambda *shape, s=1.0: torch.randn(shape, generator=gen,
                                              device=device) * s
        x, g = r(C512_BATCH, h, w, cw), r(C512_BATCH, h, w, cw)
        wts = (x, r(3, 3, 2 * cw, cw, s=(18 * cw) ** -0.5), r(cw, s=0.1),
               r(2 * cw, 2 * cw, s=(2 * cw) ** -0.5), r(2 * cw, s=0.1))
        seed = torch.tensor([2468 + cw], dtype=torch.int32, device=device)
        pixels = C512_BATCH * h * w
        for rate in (0.0, RATE):
            tag = f"gated conv C={cw} {h}x{w} batch {C512_BATCH} rate {rate}"
            fwd_err, bwd_err, over = _gated_conv_checks(kernels, wts, g, rate,
                                                        seed, tag)
            launches = _gated_conv_launches(kernels, wts, g, rate, seed, tag)
            common = dict(shape=f"{h}x{w}", batch=C512_BATCH, c=cw,
                          rate=rate, library_ms=None)
            for name, backward, err in (("fused_gated_conv", False, fwd_err),
                                        ("fused_gated_conv_bwd", True,
                                         bwd_err)):
                row = dict(common, max_abs_err=err, device_launches=launches[
                    "bwd" if backward else "fwd"])
                if (cw, h, rate) == (512, 16, 0.0):  # the CLIs' level 0
                    with torch.no_grad():
                        if backward:
                            row["ms"] = timer(lambda: kernels.
                                              fused_gated_conv_bwd(*wts, g))
                            row["plain_ms"] = timer(
                                lambda: kernels.gated_conv_plain_bwd(*wts, g))
                        else:
                            row["ms"] = timer(
                                lambda: kernels.fused_gated_conv(*wts))
                            row["plain_ms"] = timer(
                                lambda: kernels.gated_conv_plain(*wts))
                    bound_ms, bound_by, fp32, note = _gated_conv_bound(
                        pixels, cw, backward)
                    row.update(bound_ms=bound_ms, bound_by=bound_by, **fp32)
                    log(f"  {tag}: kernel {'bwd' if backward else 'fwd'} "
                        f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms"
                        f" | bound {bound_ms * 1e3:.2f}{note} us")
                if backward:
                    row["err_over_scale"] = over
                results[name].append(row)
    return results


def fused_flagship(device, train_loader, loader, out_dir, seed, card, model,
                   trained, nll, with_profile):
    """Phase 16: the flagship at 32 px with the flag: training (phase 4's
    seeds and batches), eval and sampling on phase 5's weights, the fused
    against the unfused model on the card, card against CPU."""
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow

    out, one_step = train(device, train_loader, out_dir, seed, card,
                          fused=True, steps=FGC_TRAIN_STEPS, windows=1)
    log(f"  beside phase 4 (unfused, this run): train "
        f"{trained['train_images_per_s']:.1f} images/s, peak "
        f"{trained['train_peak_memory_bytes'] / 2 ** 30:.3f} GiB [{card}]")
    config = {**FLAGSHIP, "fused_gated_conv": True}
    served = MarScfFlow(MarScfConfig(**config), device=device).eval()
    served.load_state_dict(model.state_dict())
    out["eval_bits_per_dim"], out["eval_launches"] = serve(served, loader,
                                                           device, seed)
    log(f"  phase 5's eval bits/dim on the same weights and noise: {nll:.6f}")
    out["sample_launches"], _ = sample(served, out_dir, device, seed,
                                       "samples_fgc.png")
    out.update(timings(served, loader, device, card))
    if with_profile:
        out["profile"] = profile({"fused train step": (
            lambda gen: one_step(), True)}, device, card)
    del one_step
    x = torch.from_numpy(next(iter(loader))[:8]).to(device)
    with torch.no_grad():
        zero = torch.zeros(x.shape[0], device=device)
        _, obj_fused = served.encode(x, zero)
        _, obj_plain = model.eval().encode(x, zero)
    diff = float((obj_fused - obj_plain).abs().max()) / (
        math.log(2.0) * model.num_dims)
    log(f"  encode bits/dim fused vs unfused on the card, same weights: max "
        f"diff {diff:.3g} (bar 1e-5)")
    if not diff <= 1e-5:
        raise AssertionError(f"fused vs unfused encode {diff} > 1e-5")
    out["encode_bpd_fused_vs_unfused"] = diff
    out.update(encode_and_step_card_vs_cpu(served, x[:4].cpu(), device,
                                           config, 10))
    return out


def imagenet64_fused(device, state, seed, card):
    """Phase 16: one window of 5 training steps at 64 px and batch 64 with
    the flag, on phase 14's trained weights (after one warm-up step), with
    exact launch counts and peak memory; one eval batch. The same depth as
    phase 14, one window instead of three."""
    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import evaluate, train_step
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    model = MarScfFlow(MarScfConfig(**IMAGENET64, fused_gated_conv=True),
                       device=device)
    model.load_state_dict(state)
    train_loader, test_loader, _ = get_dataset("imagenet_64", BATCH, seed=seed)
    batches = [torch.from_numpy(b).to(device)
               for b, _ in zip(train_loader, range(WINDOW64_STEPS + 1))]
    gen = torch.Generator(device=device).manual_seed(seed + 45)
    model.train()
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=WARM_UP,
                       batch_size=BATCH)
    float(train_step(model, opt, batches[-1], gen))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, b, gen) for b in batches[:-1]]
    losses = [float(v) for v in losses]  # the window ends in loss reads
    window_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    per_step = {k: v / WINDOW64_STEPS for k, v in counts.items()}
    want = {**PER_STEP_64, **dict.fromkeys(FGC, FGC_PER_PASS)}
    ips = WINDOW64_STEPS * BATCH / window_s
    log(f"  {WINDOW64_STEPS} steps at batch {BATCH}, dropout {RATE}: losses "
        f"{[round(v, 4) for v in losses]}; launches per step {per_step}")
    log(f"  train {ips:.2f} images/s (one window of {WINDOW64_STEPS} steps: "
        f"{window_s:.3f} s), peak device memory {peak / 2 ** 30:.3f} GiB "
        f"[{card}]")
    if per_step != want:
        raise AssertionError(f"fused 64-px launches per step {per_step} != "
                             f"{want}")
    if not all(math.isfinite(v) for v in losses) or opt.total_notfinite:
        raise AssertionError(f"fused 64-px losses not finite: {losses}")
    model.eval()
    loader = NumpyLoader(test_loader.images[:BATCH], BATCH, shuffle=False)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nll = evaluate(model, loader, generator=torch.Generator(
        device=device).manual_seed(seed + 46))
    eval_s = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    want = {k: {**EVAL_64, "fused_gated_conv": FGC_PER_PASS}.get(k, 0)
            for k in eval_counts}
    log(f"  eval bits/dim {nll:.4f} over one batch of {BATCH} in "
        f"{eval_s:.3f} s; launches {eval_counts}")
    if eval_counts != want or not (math.isfinite(nll) and nll < 30.0):
        raise AssertionError(f"fused 64-px eval: {nll}, launches "
                             f"{eval_counts} != {want}")
    return {"losses": losses, "launches": counts, "launches_per_step": per_step,
            "train_images_per_s": ips, "train_window_s": window_s,
            "train_peak_memory_bytes": peak, "eval_bits_per_dim": nll,
            "eval_s": eval_s, "eval_launches": eval_counts}


def c512_fused(device, seed, card):
    """Phase 16: phase 18's --C 512 model (the CLIs' default width, L 3, K 2,
    batch 16; random weights after ddi) with fused_gated_conv=True. On the
    same weights and batch at dropout 0, the fused and the unfused model's
    step-1 loss and encode bits/dim within 1e-5; then C512_FGC_STEPS train
    steps at the model's dropout and one eval batch, with exact launch
    counts (60 gated convs a pass)."""
    import dataclasses

    from gpnf_tpu_torch.data.datasets import get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.train_marscf import model_config, parse_args
    from gpnf_tpu_torch.training.loop import train_step
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    t0 = time.perf_counter()
    cfg = model_config(parse_args(C512_ARGS))
    loader = get_dataset("synthetic", C512_BATCH, seed=seed)[0]
    batches = [torch.from_numpy(b).to(device)
               for b, _ in zip(loader, range(C512_FGC_STEPS))]
    plain = MarScfFlow(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed + 50))
    plain.ddi(batches[0], generator=torch.Generator(
        device=device).manual_seed(seed + 51))
    state = plain.state_dict()
    del plain
    log(f"  C=512: the model built and ddi in {time.perf_counter() - t0:.1f} "
        f"s")
    out = {}
    nodrop = dataclasses.replace(cfg, drop_prob=0.0)
    for name, config in (("unfused", nodrop), ("fused", dataclasses.replace(
            nodrop, fused_gated_conv=True))):
        model = MarScfFlow(config, device=device)
        model.load_state_dict(state)
        with torch.no_grad():
            zero = torch.zeros(C512_BATCH, device=device)
            obj = model.eval().encode(batches[0], zero)[1]
        opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=C512_WARM_UP,
                           batch_size=C512_BATCH)
        loss = float(train_step(model.train(), opt, batches[0],
                                torch.Generator(device=device).manual_seed(
                                    seed + 52)))
        out[name] = (obj / (math.log(2.0) * model.num_dims), loss)
        del model, opt
    encode_diff = float((out["fused"][0] - out["unfused"][0]).abs().max())
    loss_diff = abs(out["fused"][1] - out["unfused"][1])
    log(f"  C=512 fused vs unfused, same weights, dropout 0 ("
        f"{time.perf_counter() - t0:.1f} s in): step-1 loss "
        f"{out['fused'][1]:.6f} / {out['unfused'][1]:.6f} (diff "
        f"{loss_diff:.3g}), encode bits/dim max diff {encode_diff:.3g} "
        f"(bar 1e-5 each)")
    if not (loss_diff <= 1e-5 and encode_diff <= 1e-5):
        raise AssertionError(f"C=512 fused vs unfused: loss {loss_diff}, "
                             f"encode {encode_diff}")
    model = MarScfFlow(dataclasses.replace(cfg, fused_gated_conv=True),
                       device=device)
    model.load_state_dict(state)
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=C512_WARM_UP,
                       batch_size=C512_BATCH)
    gen = torch.Generator(device=device).manual_seed(seed + 53)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(train_step(model.train(), opt, b, gen)) for b in batches]
    train_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    steps = C512_FGC_STEPS * C512_ATTN
    want = {**dict.fromkeys(counts, 0), "fused_gated_conv": steps,
            "fused_gated_conv_bwd": steps, "fused_attention_long": steps,
            "attention_lanes": steps, "attention_qkv_gemm": 2 * steps,
            "fused_attention_long_bwd": steps, "attention_lanes_bwd": steps,
            "attention_dseq_gemm": steps, "attention_dw_gemm": steps,
            "mixlogcdf_forward": steps // 10}
    log(f"  C=512 with the flag: {C512_FGC_STEPS} train steps at batch "
        f"{C512_BATCH}, dropout {cfg.drop_prob}: losses "
        f"{[round(v, 4) for v in losses]}; {train_s:.2f} s, peak "
        f"{peak / 2 ** 30:.3f} GiB [{card}]; launches {counts}")
    if counts != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"C=512 fused train: losses {losses}, launches "
                             f"{counts} != {want}")
    kernels.reset_launch_counts()
    with torch.no_grad():
        nll = float(torch.mean(model.eval()(batches[0], generator=gen)[1]))
    eval_counts = kernels.launch_counts()
    want = {**dict.fromkeys(eval_counts, 0), "fused_gated_conv": C512_ATTN,
            "fused_attention_long": C512_ATTN, "attention_lanes": C512_ATTN,
            "attention_qkv_gemm": C512_ATTN,
            "mixlogcdf_forward": C512_ATTN // 10}
    log(f"  C=512 with the flag: eval bits/dim {nll:.4f} over one batch; "
        f"launches {eval_counts}")
    if eval_counts != want or not (math.isfinite(nll) and nll < 30.0):
        raise AssertionError(f"C=512 fused eval: {nll}, launches "
                             f"{eval_counts} != {want}")
    return {"step1_loss_fused_vs_unfused": loss_diff,
            "encode_bpd_fused_vs_unfused": encode_diff, "losses": losses,
            "train_s": train_s, "train_peak_memory_bytes": peak,
            "launches": counts, "eval_bits_per_dim": nll,
            "eval_launches": eval_counts}


# -- phase 17: the core attention entries (fused_attention, fused_attention_qkv) --
# (B, H, S, Dh): the flagship GatedAttn's three levels, the top of the range
# (S = 512 at Dh = 24 and 64), and a ragged S
CORE_SHAPES = ((BATCH, 4, 256, 24), (BATCH, 4, 64, 24), (BATCH, 4, 16, 24),
               (BATCH, 4, 512, 24), (BATCH, 4, 512, 64), (BATCH, 4, 100, 24))
# the forward's other narrow instantiations, packed, at S = 256
NARROW_WIDTHS = (4, 8, 16, 32, 48)
# the long entry's shapes that the core entries take on the card too: S
# 1024 (the 64-px level 0) and 2304 (a 48 x 48 level 0), past the JAX
# kernels' 512, and Dh 40 and 96, padded to the built 48 and 128
CORE_WIDE_SHAPES = ((8, 4, 1024, 24), (2, 4, 2304, 24), (BATCH, 4, 256, 40),
                    (BATCH, 4, 256, 96))


def check_core_attention(device, timer):
    """Phase 17: the four core attention kernels against their plain
    versions at CORE_SHAPES, rate 0 and 0.2 (one seed: the same mask), and
    the packed forward at the other narrow widths (NARROW_WIDTHS), two
    calls of each bit for bit the same, S = 513, Dh = 20 and float64
    refused; each with its time, the plain version's, SDPA's (rate 0) and
    its bound. Then the entries against the proj and long entries at rate
    0.2, and a drive through both public entries' autograd with the counts
    set to 0 just before: one launch of each kernel."""
    from gpnf_tpu_torch.ops import kernels

    counts = kernels.launch_counts()
    if any(counts[n] for n in CORE + CORE_BF16):
        raise AssertionError(f"an earlier phase launched a core attention "
                             f"kernel: {counts}")
    gen = torch.Generator(device=device).manual_seed(9753)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    results = {name: [] for name in CORE}

    def record(name, shape, rate, err, ms, plain_ms, library_ms):
        b, h, s, dh = shape
        scores = b * h * s * s
        core = 2 * scores * dh  # one S x S x Dh product
        elems = b * h * s * dh
        # on the tensor cores: q, k, v in (or qkv), out, two products and
        # the softmax forward; q, k, v, g in, dq, dk, dv out, five products
        # and dS backward
        if name in ("fused_attention", "fused_attention_qkv"):
            bytes_moved, ops = 4 * 4 * elems, 2 * core
        else:
            bytes_moved, ops = 4 * 7 * elems, 5 * core
        bound_ms, bound_by, extra, fp32 = tensor_core_bound(
            bytes_moved, ops + 5 * scores)
        results[name].append(dict(
            shape=list(shape), rate=rate, max_abs_err=err[0],
            err_over_scale=err[1], ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            **extra))
        ms_or_na = lambda v: "n/a" if v is None else f"{v:.4f} ms"
        log(f"  {name} {shape} rate {rate}: max abs err {err[0]:.3g} (/ max "
            f"|plain| {err[1]:.3g}) | kernel {ms:.4f} ms plain "
            f"{ms_or_na(plain_ms)} library {ms_or_na(library_ms)} | bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}{fp32})")

    def check(tag, got, want, again, bar=None):
        """Max abs error and max abs error / max |plain| over the outputs;
        the forward's bar is absolute (1e-5), the backward's relative to
        each gradient's largest value (1e-4), and two calls must agree bit
        for bit."""
        if not all(
                torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two calls differ")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        over = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(got, want))
        if not (err <= 1e-5 if bar is None else over <= bar):
            raise AssertionError(f"{tag}: max abs err {err}, / max |plain| "
                                 f"{over}")
        return err, over

    def sdpa_bwd_ms(q, k, v, g, scale):
        """Autograd backward of SDPA, the graph built once and its backward
        timed alone."""
        q, k, v = (t_.clone().requires_grad_() for t_ in (q, k, v))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                 retain_graph=True))

    with torch.no_grad():
        for shape in CORE_SHAPES + CORE_WIDE_SHAPES:
            b, h, s, dh = shape
            q, k, v, g = (randn(*shape) * 0.5 for _ in range(4))
            merge = lambda x: x.transpose(1, 2).reshape(b, s, h * dh)
            # the same heads packed, q unscaled: the same function
            qkv = torch.cat([merge(k), merge(v), merge(q) * dh ** 0.5],
                            dim=-1).contiguous()
            g3 = merge(g).contiguous()
            kk, vv, qq = (t_.reshape(b, s, h, dh).transpose(1, 2).contiguous()
                          for t_ in qkv.split(h * dh, dim=-1))
            seed = torch.tensor([2024 + s + dh], dtype=torch.int32,
                                device=device)
            for rate in (0.0, RATE):
                cases = (
                    ("fused_attention",
                     lambda: (kernels.fused_attention(q, k, v, rate, seed),),
                     lambda: (kernels.attention_plain(q, k, v, rate, seed),),
                     lambda: F.scaled_dot_product_attention(q, k, v,
                                                            scale=1.0)),
                    ("fused_attention_bwd",
                     lambda: kernels.fused_attention_bwd(q, k, v, g, rate,
                                                         seed),
                     lambda: kernels.attention_plain_bwd(q, k, v, g, rate,
                                                         seed),
                     lambda: sdpa_bwd_ms(q, k, v, g, 1.0)),
                    ("fused_attention_qkv",
                     lambda: (kernels.fused_attention_qkv(qkv, h, rate,
                                                          seed),),
                     lambda: (kernels.attention_long_plain(qkv, h, rate,
                                                           seed),),
                     lambda: F.scaled_dot_product_attention(qq, kk, vv)),
                    ("fused_attention_qkv_bwd",
                     lambda: (kernels.fused_attention_qkv_bwd(qkv, g3, h, rate,
                                                              seed),),
                     lambda: (kernels.attention_long_plain_bwd(qkv, g3, h,
                                                               rate, seed),),
                     lambda: sdpa_bwd_ms(qq, kk, vv, g, None)))
                for name, run, plain, library in cases:
                    backward = name.endswith("_bwd")
                    err = check(f"{name} {shape} rate {rate}", run(), plain(),
                                run(), 1e-4 if backward else None)
                    library_ms = None
                    if rate == 0.0:  # no PyTorch call draws the kernel's mask
                        library_ms = library() if backward else timer(library)
                    record(name, shape, rate, err, timer(run), timer(plain),
                           library_ms)

        for dh in NARROW_WIDTHS:
            shape = (BATCH, 4, 256, dh)
            qkv = randn(BATCH, 256, 3 * 4 * dh) * 0.5
            kk, vv, qq = (t_.reshape(BATCH, 256, 4, dh).transpose(1, 2)
                          .contiguous() for t_ in qkv.split(4 * dh, dim=-1))
            seed = torch.tensor([2024 + dh], dtype=torch.int32, device=device)
            for rate in (0.0, RATE):
                run = lambda: (kernels.fused_attention_qkv(qkv, 4, rate,
                                                           seed),)
                plain = lambda: (kernels.attention_long_plain(qkv, 4, rate,
                                                              seed),)
                err = check(f"fused_attention_qkv {shape} rate {rate}", run(),
                            plain(), run())
                record("fused_attention_qkv", shape, rate, err, timer(run),
                       timer(plain), timer(
                           lambda: F.scaled_dot_product_attention(qq, kk, vv))
                       if rate == 0.0 else None)

        # one seed at rate 0.2: every attention entry drops the same scores
        for s in (256, 64, 16, 100, 512):
            seq, w = randn(8, s, 96) * 0.5, randn(288, 96) * 0.1
            g3 = randn(8, s, 96)
            seed = torch.tensor([77 + s], dtype=torch.int32, device=device)
            qkv = torch.matmul(seq, w.t())
            out = kernels.fused_attention_qkv(qkv, 4, RATE, seed)
            dqkv = kernels.fused_attention_qkv_bwd(qkv, g3, 4, RATE, seed)
            proj = kernels.fused_attention_proj(seq, w, 4, RATE, seed)
            dseq, dw = kernels.fused_attention_proj_bwd(seq, w, g3, 4, RATE,
                                                        seed)
            kk, vv, qq = (t_.reshape(8, s, 4, 24).transpose(1, 2).contiguous()
                          for t_ in qkv.split(96, dim=-1))
            merge = lambda x: x.transpose(1, 2).reshape(8, s, 96)
            split_out = merge(kernels.fused_attention(qq * 24 ** -0.5, kk, vv,
                                                      RATE, seed))
            dq, dk, dv = kernels.fused_attention_bwd(
                qq * 24 ** -0.5, kk, vv, g3.reshape(8, s, 4, 24).transpose(
                    1, 2).contiguous(), RATE, seed)
            split_d = torch.cat([merge(dk), merge(dv), merge(dq) * 24 ** -0.5],
                                dim=-1)
            same = {
                "qkv vs proj out": float((out - proj).abs().max()),
                "qkv vs proj dseq / max": float(
                    (torch.matmul(dqkv, w) - dseq).abs().max()
                    / dseq.abs().max()),
                "qkv vs proj dW / max": float(
                    (torch.einsum("bso,bsc->oc", dqkv, seq) - dw).abs().max()
                    / dw.abs().max()),
                "split vs packed out": float((split_out - out).abs().max()),
                "split vs packed dqkv / max": float(
                    (split_d - dqkv).abs().max() / dqkv.abs().max())}
            long_equal = (
                torch.equal(out, kernels.attention_long_qkv(qkv, 4, RATE,
                                                            seed))
                and torch.equal(dqkv, kernels.attention_long_qkv_bwd(
                    qkv, g3, 4, RATE, seed)))
            log(f"  rate {RATE}, S={s}, one seed: "
                + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in same.items())
                + f"; qkv vs long bit for bit: {long_equal}")
            if not (long_equal and same["qkv vs proj out"] <= 1e-5
                    and same["split vs packed out"] <= 1e-5 and all(
                        v_ <= 1e-4 for k_, v_ in same.items() if "/" in k_)):
                raise AssertionError(f"the attention entries disagree at "
                                     f"S={s}: {same}, long {long_equal}")
            results.setdefault("agreement", []).append(
                dict(s=s, long_bit_for_bit=long_equal, **same))

        # where the long entry raises (S past MAX_S_LONG: zero-stride
        # operands, refused before any copy; Dh above 256), and float64
        fa = importlib.import_module(
            "gpnf_tpu_torch.ops.kernels.fused_attention")
        refusals = {
            f"S={fa.MAX_S_LONG + 1}": ((1, 4, fa.MAX_S_LONG + 1, 24),
                                       torch.float32),
            "Dh=260": ((1, 4, 64, 260), torch.float32),
            "float64": ((1, 4, 64, 24), torch.float64)}
        for label, (shape, dtype) in refusals.items():
            zero = torch.zeros(1, dtype=dtype, device=device)
            q = zero.expand(shape)
            qkv = zero.expand((1, shape[2], 3 * 4 * shape[3]))
            g3 = zero.expand((1, shape[2], 4 * shape[3]))
            for call in (lambda: kernels.fused_attention(q, q, q),
                         lambda: kernels.fused_attention_bwd(q, q, q, q),
                         lambda: kernels.fused_attention_qkv(qkv, 4),
                         lambda: kernels.fused_attention_qkv_bwd(qkv, g3, 4)):
                try:
                    call()
                except (TypeError, ValueError) as e:
                    message = str(e)
                else:
                    raise AssertionError(f"a core attention kernel took "
                                         f"{label}")
            log(f"  {label} refused before the device: {message}")

    t0 = time.perf_counter()
    results.update(check_core_bf16(device, timer))
    log(f"  the bf16 checks took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    results["beyond_2048"] = check_beyond_2048(device)
    log(f"  the S 2304 checks took {time.perf_counter() - t0:.1f} s")

    # the drive: both public entries through autograd at the flagship's
    # level 0, rate 0.2, in float32 and in bf16, the counts set to 0 just
    # before
    b, h, s, dh = CORE_SHAPES[0]
    q, k, v, g = (randn(*CORE_SHAPES[0]) * 0.5 for _ in range(4))
    qkv, g3 = randn(b, s, 3 * h * dh) * 0.5, randn(b, s, h * dh)
    seed = torch.tensor([31], dtype=torch.int32, device=device)
    runs = [[t_.to(dtype).clone().requires_grad_() for t_ in (q, k, v, qkv)]
            for dtype in (torch.float32, torch.bfloat16)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for leaves in runs:
        dtype = leaves[0].dtype
        kernels.fused_attention(*leaves[:3], RATE, seed).backward(g.to(dtype))
        kernels.fused_attention_qkv(leaves[3], h, RATE, seed).backward(
            g3.to(dtype))
    torch.cuda.synchronize()
    drive = kernels.launch_counts()
    want = {name: 2 * (name in CORE) + (name in CORE_BF16) for name in drive}
    log(f"  drive through fused_attention and fused_attention_qkv (autograd, "
        f"B={b} H={h} S={s} Dh={dh}, rate {RATE}, float32 then bf16): "
        f"launches {drive}")
    if drive != want:
        raise AssertionError(f"core attention drive launches {drive} != "
                             f"{want}")
    with torch.no_grad():
        for leaves in runs:
            q_, k_, v_, qkv_ = (t_.detach() for t_ in leaves)
            grads = (*kernels.fused_attention_bwd(q_, k_, v_,
                                                  g.to(q_.dtype), RATE, seed),
                     kernels.fused_attention_qkv_bwd(qkv_, g3.to(q_.dtype), h,
                                                     RATE, seed))
            if not all(torch.equal(leaf.grad, want_) and bool(
                    torch.isfinite(leaf.grad).all())
                    for leaf, want_ in zip(leaves, grads)):
                raise AssertionError(f"the {q_.dtype} drive's gradients are "
                                     f"not the backward kernels' or not "
                                     f"finite")
    return results, drive


def _core_bf16_bound(name, shape):
    """(bound_ms, bound_by, the exponentials' ms) of a bf16 core entry at
    (B, H, S, Dh): the bytes of its bf16 operands in and out at 3.35 TB/s,
    against its products: the forward's two (q K^T, P V) and the packed
    backward's five (Pd and dS rounded to bf16) at the dense bf16 rate;
    the split backward's q K^T and g V^T at that rate and its three
    products of a float32 intermediate (dV = Pd^T g, dq = dS K, dK = dS^T
    q) at a third of it (a float32 value is three bf16 parts, 24 bits);
    and the exponentials, one a score, at the special-function unit's
    ~3.9e12 a second (PEAK_EXP), operations too, whose time is also
    returned alone."""
    b, h, s, dh = shape
    core = 2 * b * h * s * s * dh
    elems = b * h * s * dh
    exp_ms = b * h * s * s / PEAK_EXP * 1e3
    if name.endswith("_bwd_bf16"):
        bytes_moved = 2 * 7 * elems
        ops = 5 * core if "qkv" in name else 2 * core + 3 * 3 * core
    else:
        bytes_moved, ops = 2 * 4 * elems, 2 * core
    bound_ms, bound_by = _bf16_bound(bytes_moved, ops)
    if exp_ms > bound_ms:
        bound_ms, bound_by = exp_ms, "operations"
    return bound_ms, bound_by, exp_ms


def check_core_bf16(device, timer):
    """Phase 17 on bf16 operands: the four core entries against their plain
    bf16 versions at CORE_SHAPES, rate 0 and 0.2 (one seed: the same mask):
    the forwards within BF16_FWD_BAR max |v| (P rounded at another point,
    as in phase 19); the split backward (`_bwd_kernel`'s recipe: 3xTF32's
    float32 products on the widened values, rounded once) within one bf16
    ulp of each gradient's largest |plain| with at most 5% of its values
    differing (`bf16_top_ulp_readings`); the packed backward (the bf16
    pair of phase 20) within BF16_BWD_BAR of each third's largest; two
    calls of each bit for bit; each with its time, its plain version's,
    SDPA's on bf16 at rate 0 (scale 1 on the split heads; SDPA's autograd
    backward for the backwards) and its bound. Then the split entry at Dh
    4 (its zero-padded copy, counted) and 48, S 256."""
    from gpnf_tpu_torch.ops import kernels

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
    gen = torch.Generator(device=device).manual_seed(1717)
    randn = lambda *shape: (torch.randn(shape, generator=gen, device=device)
                            * 0.5).to(torch.bfloat16)
    rows = {name: [] for name in CORE_BF16}

    def sdpa_bwd_ms(q, k, v, g, scale):
        q, k, v = (t_.clone().requires_grad_() for t_ in (q, k, v))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                 retain_graph=True))

    def held(name, got, want, v):
        """(max abs err, the readings) of a result against its plain
        version, and whether it holds its bar."""
        if name in ("fused_attention_bf16", "fused_attention_qkv_bf16"):
            err = float((got[0].float() - want[0].float()).abs().max())
            bar = BF16_FWD_BAR * float(v.float().abs().max())
            return err, {"bar": bar}, err <= bar
        if name == "fused_attention_bwd_bf16":
            readings = [fa.bf16_top_ulp_readings(a, b_)
                        for a, b_ in zip(got, want)]
            return (max(r[0] for r in readings),
                    {"dq_dk_dv_err_ulp_share": [r[:3] for r in readings]},
                    all(r[3] for r in readings))
        c = got[0].shape[-1] // 3
        errs = [float((got[0][..., i * c:(i + 1) * c].float()
                       - want[0][..., i * c:(i + 1) * c].float()).abs().max()
                      / want[0][..., i * c:(i + 1) * c].float().abs().max())
                for i in range(3)]
        return max(errs), {"rel_err_dk_dv_dq": errs}, max(errs) <= BF16_BWD_BAR

    shapes = CORE_SHAPES + CORE_WIDE_SHAPES + ((BATCH, 4, 256, 4),
                                               (BATCH, 4, 256, 48))
    with torch.no_grad():
        for shape in shapes:
            b, h, s, dh = shape
            q, k, v, g = (randn(*shape) for _ in range(4))
            merge = lambda x: x.transpose(1, 2).reshape(b, s, h * dh)
            qkv = torch.cat([merge(k), merge(v), merge(q)], dim=-1)
            g3 = merge(g).contiguous()
            kk, vv, qq = (t_.reshape(b, s, h, dh).transpose(1, 2).contiguous()
                          for t_ in qkv.split(h * dh, dim=-1))
            seed = torch.tensor([2025 + s + dh], dtype=torch.int32,
                                device=device)
            packed = shape in CORE_SHAPES + CORE_WIDE_SHAPES
            for rate in (0.0, RATE):
                cases = [
                    ("fused_attention_bf16",
                     lambda: (kernels.fused_attention(q, k, v, rate, seed),),
                     lambda: (kernels.attention_plain(q, k, v, rate, seed),),
                     lambda: timer(lambda: F.scaled_dot_product_attention(
                         q, k, v, scale=1.0)), v),
                    ("fused_attention_bwd_bf16",
                     lambda: kernels.fused_attention_bwd(q, k, v, g, rate,
                                                         seed),
                     lambda: kernels.attention_plain_bwd(q, k, v, g, rate,
                                                         seed),
                     lambda: sdpa_bwd_ms(q, k, v, g, 1.0), v)]
                if packed:
                    cases += [
                        ("fused_attention_qkv_bf16",
                         lambda: (kernels.fused_attention_qkv(qkv, h, rate,
                                                              seed),),
                         lambda: (kernels.attention_long_plain(qkv, h, rate,
                                                               seed),),
                         lambda: timer(lambda: F.scaled_dot_product_attention(
                             qq, kk, vv)), vv),
                        ("fused_attention_qkv_bwd_bf16",
                         lambda: (kernels.fused_attention_qkv_bwd(
                             qkv, g3, h, rate, seed),),
                         lambda: (kernels.attention_long_plain_bwd(
                             qkv, g3, h, rate, seed,
                             scale_dq_in_fp32=True),),
                         lambda: sdpa_bwd_ms(qq, kk, vv, g, None), vv)]
                for name, run, plain, library, vals in cases:
                    padded = kernels.core_bf16_padded.launches
                    got = run()
                    again = run()
                    same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                    err, extra, ok = held(name, got, plain(), vals)
                    bound_ms, bound_by, exp_ms = _core_bf16_bound(name, shape)
                    row = dict(shape=list(shape), rate=rate, max_abs_err=err,
                               **extra, ms=timer(run), plain_ms=timer(plain),
                               library_ms=library() if rate == 0.0 else None,
                               bound_ms=bound_ms, bound_by=bound_by,
                               exp_bound_ms=exp_ms,
                               bound_peak="bf16 989 TFLOP/s",
                               padded_copy=kernels.core_bf16_padded.launches
                               > padded)
                    rows[name].append(row)
                    lib = row["library_ms"]
                    log(f"  {name} {shape} rate {rate}: max abs err {err:.3g}"
                        f" {extra}; two calls bit for bit: {same}"
                        + ("; Dh 4 through a zero-padded copy"
                           if row["padded_copy"] else "")
                        + f" | kernel {row['ms']:.4f} ms plain "
                        f"{row['plain_ms']:.4f} ms"
                        + (f" SDPA (bf16) {lib:.4f} ms" if lib else "")
                        + f" | bound {bound_ms * 1e3:.2f} us ({bound_by}; "
                        f"exponentials {exp_ms * 1e3:.2f} us)")
                    if not (ok and same):
                        raise AssertionError(f"{name} {shape} rate {rate}: "
                                             f"within bar {ok}, repeat {same}"
                                             f": {extra}")
        mixed = torch.zeros((1, 4, 64, 24), device=device)
        try:
            kernels.fused_attention(mixed.to(torch.bfloat16), mixed, mixed)
        except TypeError as e:
            log(f"  mixed dtypes refused before the device: {e}")
        else:
            raise AssertionError("a core attention kernel took bf16 and "
                                 "float32 operands together")
    return rows


def check_beyond_2048(device):
    """S 2304 (a 48 x 48 level 0), past the 2048 the long kernels once
    stopped at: GatedAttn (C 96, batch 2, training, rate 0.2, one seed)
    forward and backward on the long entry's kernels against the same
    module with the plain versions in their place (mixlogcdf's
    `fused_attention_long` patched), in float32 (out within 1e-5, every
    gradient within 1e-4 of its largest) and bf16 (out, dx and each
    weight's gradient within `grad_parity`'s bar of the plain bf16
    module's: 3 times its distance from the float32 module's); the bf16
    forward at Dh 24 and at W 128 and 256 (C 96, 512 and 1024, batch 2,
    rate 0 and 0.2; the wide tiles sum P V in the accumulators over 36 or
    72 key tiles) against its plain version (BF16_FWD_BAR max |v|);
    and the bf16 backward at batch 64, H 4 (its keep bits' scratch, B H
    Sp^2 / 8 bytes, 170 MB), two calls bit for bit and its first two batch
    rows against the plain version (BF16_BWD_BAR)."""
    from gpnf_tpu_torch.ops import kernels, mixlogcdf

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
    out = {}
    gen = torch.Generator(device=device).manual_seed(2304)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    attn = mixlogcdf.GatedAttn(96, drop_prob=RATE).to(device).train()
    x32, g32 = randn(2, 48, 48, 96), randn(2, 48, 48, 96) * 0.5
    kernel_entry = mixlogcdf.fused_attention_long

    def plain_entry(seq, w, heads, rate, seed):
        return kernels.attention_long_plain(fa.qkv_plain(seq, w), heads,
                                            rate, seed)

    from gpnf_tpu_torch.utils import grad_parity

    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for path, entry in (("kernels", kernel_entry), ("plain", plain_entry)):
            mixlogcdf.fused_attention_long = entry
            try:
                attn.zero_grad()
                leaf = x32.to(dtype).clone().requires_grad_()
                kernels.reset_launch_counts()
                y = attn(leaf, generator=torch.Generator(
                    device=device).manual_seed(5))
                y.backward(g32.to(dtype))
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            finally:
                mixlogcdf.fused_attention_long = kernel_entry
            runs[dtype, path] = {
                "out": y.detach().float(), "dx": leaf.grad.float(),
                **{n: p_.grad.float() for n, p_ in attn.named_parameters()}}
            if path == "kernels" and (
                    counts["fused_attention_long"],
                    counts["fused_attention_long_bwd"]) != (1, 1):
                raise AssertionError(f"GatedAttn at S 2304 ran {counts}")
    got, want = runs[torch.float32, "kernels"], runs[torch.float32, "plain"]
    errs = {n: float((got[n] - b_).abs().max() / b_.abs().max())
            for n, b_ in want.items()}
    abs_out = float((got["out"] - want["out"]).abs().max())
    out["float32"] = dict(out_max_abs_err=abs_out,
                          rel_err_out_dx_weights=errs)
    log(f"  GatedAttn C 96, 48 x 48 (S 2304), batch 2, rate {RATE}, float32: "
        f"kernels vs plain max |out| err {abs_out:.3g}, max err / max |plain|"
        f" {[f'{e:.3g}' for e in errs.values()]}")
    if not (abs_out <= 1e-5 and max(v for n, v in errs.items()
                                    if n != "out") <= 1e-4):
        raise AssertionError(f"GatedAttn at S 2304 float32: {errs}")
    got16 = runs[torch.bfloat16, "kernels"]
    rows = grad_parity.bf16_grad_parity(got16, runs[torch.bfloat16, "plain"],
                                        want)
    out["bf16"] = dict(worst_ratio=rows[0][0], rows=[list(r) for r in rows])
    log(f"  GatedAttn at S 2304 in bf16: out, dx and each weight's gradient "
        f"against the plain bf16 module, within grad_parity's bar (3 x its "
        f"distance from the float32 module): worst {rows[0][0]:.3g} "
        f"({rows[0][1]})")
    if rows[0][0] > 1.0 or not all(bool(torch.isfinite(a).all())
                                   for a in got16.values()):
        raise AssertionError(f"GatedAttn at S 2304 bf16: {rows[:3]}")
    seed = torch.tensor([23], dtype=torch.int32, device=device)
    out["bf16_forward"] = []
    for c in (96, 512, 1024):
        qkv = randn(2, 2304, 3 * c).to(torch.bfloat16)
        for rate in (0.0, RATE):
            got = kernels.attention_long_qkv(qkv, 4, rate, seed)
            want = kernels.attention_long_plain(qkv, 4, rate, seed)
            err = float((got.float() - want.float()).abs().max())
            vmax = float(qkv[..., c:2 * c].float().abs().max())
            out["bf16_forward"].append(dict(c=c, rate=rate, max_abs_err=err,
                                            err_over_max_v=err / vmax))
            log(f"  bf16 forward C {c} (Dh {c // 4}), S 2304, rate {rate}: "
                f"max abs err {err:.3g} = {err / vmax:.3g} max |v| (bar "
                f"{BF16_FWD_BAR:.3g})")
            if err > BF16_FWD_BAR * vmax:
                raise AssertionError(f"bf16 forward C {c} at S 2304: {err}")
    qkv = (randn(64, 2304, 288) * 0.5).to(torch.bfloat16)
    g3 = randn(64, 2304, 96).to(torch.bfloat16)
    scratch = fa.keep_bits_scratch(64, 4, 2304, RATE, "meta").numel() * 4
    dqkv = kernels.attention_long_qkv_bwd(qkv, g3, 4, RATE, seed)
    same = torch.equal(dqkv, kernels.attention_long_qkv_bwd(qkv, g3, 4, RATE,
                                                            seed))
    want = kernels.attention_long_plain_bwd(qkv[:2], g3[:2], 4, RATE, seed)
    errs = [float((dqkv[:2, :, i * 96:(i + 1) * 96].float()
                   - want[..., i * 96:(i + 1) * 96].float()).abs().max()
                  / want[..., i * 96:(i + 1) * 96].float().abs().max())
            for i in range(3)]
    out["bf16_backward_b64"] = dict(keep_scratch_bytes=scratch,
                                    bit_for_bit=same, rel_err_dk_dv_dq=errs)
    log(f"  bf16 backward B 64, H 4, S 2304, rate {RATE}: keep-bit scratch "
        f"{scratch} bytes; two calls bit for bit: {same}; rows 0-1 vs plain "
        f"max err / max |plain| dK dV dq {[f'{e:.3g}' for e in errs]}")
    if not (same and bool(torch.isfinite(dqkv).all())
            and max(errs) <= BF16_BWD_BAR):
        raise AssertionError(f"bf16 backward at B 64, S 2304: {same} {errs}")
    return out


# -- phase 18: GatedAttn at every width, the CLIs' default --C 512 -----------------
C512_BATCH, C512_STEPS, C512_WARM_UP = 16, 12, 64
# both CLIs at their defaults (--C 512, --coupling mixlogcdf) on the synthetic
# set, depth cut to L 3, K 2: 60 GatedAttn a forward (L * K * 10 blocks), 4
# heads of Dh = 128, the wide route at every level
C512_ARGS = ["--dataset_name", "synthetic", "--L", "3", "--K", "2",
             "--batch_size", str(C512_BATCH), "--device", "cuda"]
C512_ATTN = 3 * 2 * 10
# (C, batch, S) of the Dh = 128 / 256 kernels' checks: the CLIs' width at the
# 32-px levels' S, and Dh = 256 (C = 1024) at level 0
LANE_CASES = ((512, C512_BATCH, 256), (512, C512_BATCH, 64),
              (512, C512_BATCH, 16), (1024, 4, 256))


def check_lane_kernels(device, timer):
    """Phase 18's kernel checks: the tensor-core forward and backward (Dh =
    128, 256) through the long entry's wrappers against their plain
    versions at LANE_CASES, rate 0 and 0.2 (one seed: the same mask), two
    calls of each bit for bit, each with its time, the plain
    version's, SDPA's after a head split (rate 0) and its bound; at the
    CLIs' width the wide route's GEMMs (qkv = seq w^T, dseq, dW) against
    torch.matmul, two calls bit for bit, with their times and bounds; then
    the whole wide route (the GEMMs around the Dh = 128 kernels) beside
    autograd of F.linear + SDPA."""
    from gpnf_tpu_torch.ops import kernels

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
    counts = kernels.launch_counts()
    if any(counts[n] for n in LANES):
        raise AssertionError(f"an earlier phase launched a Dh = 128 / 256 "
                             f"kernel: {counts}")
    gen = torch.Generator(device=device).manual_seed(2468)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    heads = 4
    results = {name: [] for name in (*LANES, *GEMMS, "wide_route")}

    def record(name, c, batch, s, rate, err, ms, plain_ms, library_ms):
        dh = c // heads
        scores = batch * heads * s * s
        core = 2 * scores * dh  # one S x S x Dh product
        rows = batch * s
        # the products on the tensor cores in 3xTF32
        if name == "attention_lanes":  # qkv in, out; two products, softmax
            bytes_moved, ops = 4 * (rows * 3 * c + rows * c), 2 * core
        else:  # qkv and g in, dqkv out; five products and dS
            bytes_moved, ops = 4 * (2 * rows * 3 * c + rows * c), 5 * core
        bound_ms, bound_by, extra, fp32 = tensor_core_bound(
            bytes_moved, ops + 5 * scores)
        results[name].append(dict(
            c=c, head_dim=dh, batch=batch, s=s, rate=rate, max_abs_err=err[0],
            err_over_scale=err[1], ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            **extra))
        ms_or_na = lambda v: "n/a" if v is None else f"{v:.4f} ms"
        log(f"  {name} C={c} (Dh {dh}) B={batch} S={s} rate {rate}: max abs "
            f"err {err[0]:.3g} (/ max |plain| {err[1]:.3g}) | kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{ms_or_na(library_ms)} | bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}{fp32})")

    def check(tag, got, want, bar):
        err = float((got - want).abs().max())
        over = err / float(want.abs().max())
        if not (bool(torch.isfinite(got).all()) and over <= bar):
            raise AssertionError(f"{tag}: max abs err {err}, / max |plain| "
                                 f"{over} > {bar}")
        return err, over

    def heads_of(x, dh, grad=False):
        b, s, _ = x.shape
        x = x.reshape(b, s, heads, dh).transpose(1, 2).contiguous()
        return x.requires_grad_() if grad else x

    def sdpa_bwd_ms(qkv, g, dh):
        """Autograd backward of SDPA on the heads, the graph built once and
        its backward timed alone."""
        k, v, q = (heads_of(t_, dh, True) for t_ in qkv.split(heads * dh, -1))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), heads_of(
            g, dh), retain_graph=True))

    def library(seq, w, dh):
        """F.linear + SDPA: the wide route's function in PyTorch calls."""
        b, s, c = seq.shape
        k, v, q = (heads_of(t_, dh) for t_ in F.linear(seq, w).split(c, -1))
        return F.scaled_dot_product_attention(q, k, v).transpose(
            1, 2).reshape(b, s, c)

    with torch.no_grad():
        for c, batch, s in LANE_CASES:
            dh = c // heads
            seq, w = randn(batch, s, c) * 0.5, randn(3 * c, c) * 0.1
            qkv, g = torch.matmul(seq, w.t()), randn(batch, s, c)
            seed = torch.tensor([1357 + s + c], dtype=torch.int32,
                                device=device)
            for rate in (0.0, RATE):
                fwd = lambda: kernels.attention_long_qkv(qkv, heads, rate, seed)
                plain = lambda: kernels.attention_long_plain(qkv, heads, rate,
                                                             seed)
                # a score sums Dh products of values up to ~2: held to the
                # output's scale
                got = fwd()
                if not torch.equal(got, fwd()):
                    raise AssertionError(f"attention_lanes C={c} S={s} "
                                         f"rate {rate}: two calls differ")
                err = check(f"attention_lanes C={c} S={s} rate {rate}",
                            got, plain(), 1e-5)
                k4, v4, q4 = (heads_of(t_, dh) for t_ in qkv.split(c, -1))
                record("attention_lanes", c, batch, s, rate, err, timer(fwd),
                       timer(plain), timer(
                           lambda: F.scaled_dot_product_attention(q4, k4, v4))
                       if rate == 0.0 else None)
                bwd = lambda: kernels.attention_long_qkv_bwd(qkv, g, heads,
                                                             rate, seed)
                plain_b = lambda: kernels.attention_long_plain_bwd(
                    qkv, g, heads, rate, seed)
                got = bwd()
                if not torch.equal(got, bwd()):
                    raise AssertionError(f"attention_lanes_bwd C={c} S={s} "
                                         f"rate {rate}: two calls differ")
                err = check(f"attention_lanes_bwd C={c} S={s} rate {rate}",
                            got, plain_b(), 1e-4)
                record("attention_lanes_bwd", c, batch, s, rate, err,
                       timer(bwd), timer(plain_b),
                       sdpa_bwd_ms(qkv, g, dh) if rate == 0.0 else None)
            if c != 512:
                continue
            # the wide route's GEMMs at the path's shapes: (m, n, k) of
            # c (m x n) = A (m x k) B (k x n); torch.matmul is the plain
            # version, one cuBLAS call (torch.mm) the library's
            dqkv = randn(batch, s, 3 * c)
            rows = batch * s
            for name, fn, plain, lib, (m, n, k) in (
                    ("attention_qkv_gemm",
                     lambda: kernels.attention_qkv_gemm(seq, w),
                     lambda: torch.matmul(seq, w.t()),
                     lambda: torch.mm(seq.view(rows, c), w.t()),
                     (rows, 3 * c, c)),
                    ("attention_dseq_gemm",
                     lambda: kernels.attention_dseq_gemm(dqkv, w),
                     lambda: torch.matmul(dqkv, w),
                     lambda: torch.mm(dqkv.view(rows, 3 * c), w),
                     (rows, c, 3 * c)),
                    ("attention_dw_gemm",
                     lambda: kernels.attention_dw_gemm(dqkv, seq),
                     lambda: torch.einsum("bso,bsc->oc", dqkv, seq),
                     lambda: torch.mm(dqkv.view(rows, 3 * c).t(),
                                      seq.view(rows, c)),
                     (3 * c, c, rows))):
                got = fn()
                if not torch.equal(got, fn()):
                    raise AssertionError(f"{name} C={c} S={s}: two calls "
                                         f"differ")
                # k products a sum, in float32: held to the output's scale
                err = check(f"{name} C={c} S={s}", got, plain(), 1e-5)
                # the products on the tensor cores in 3xTF32
                bound_ms, bound_by, extra, fp32 = tensor_core_bound(
                    4 * (m * k + k * n + m * n), 2 * m * n * k)
                row = dict(c=c, batch=batch, s=s, m=m, n=n, k=k,
                           tile=fa.gemm_tile(m, n),
                           splits=fa.gemm_splits(m, n, k),
                           max_abs_err=err[0], err_over_scale=err[1],
                           ms=timer(fn), plain_ms=timer(plain),
                           library_ms=timer(lib), bound_ms=bound_ms,
                           bound_by=bound_by, **extra)
                results[name].append(row)
                log(f"  {name} C={c} B={batch} S={s} (m {m}, n {n}, k {k}): "
                    f"max abs err {err[0]:.3g} (/ max |plain| {err[1]:.3g}) "
                    f"| kernel {row['ms']:.4f} ms plain "
                    f"{row['plain_ms']:.4f} ms library (torch.mm) "
                    f"{row['library_ms']:.4f} ms | bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}{fp32})")
            # the whole wide route at the CLIs' width, beside F.linear + SDPA
            row = dict(c=c, batch=batch, s=s)
            for rate in (0.0, RATE):
                row[f"fwd_rate{rate}_ms"] = timer(
                    lambda: kernels.fused_attention_long(seq, w, heads, rate,
                                                         seed))
                row[f"bwd_rate{rate}_ms"] = timer(
                    lambda: kernels.fused_attention_long_bwd(seq, w, g, heads,
                                                             rate, seed))
            row["library_fwd_ms"] = timer(lambda: library(seq, w, dh))
            seq_r, w_r = seq.clone().requires_grad_(), w.clone().requires_grad_()
            with torch.enable_grad():
                out = library(seq_r, w_r, dh)
            row["library_bwd_ms"] = timer(lambda: torch.autograd.grad(
                out, (seq_r, w_r), g, retain_graph=True))
            results["wide_route"].append(row)
            log(f"  wide route C={c} B={batch} S={s}: "
                + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in row.items()
                            if k_.endswith("ms"))
                + " (library: F.linear + SDPA, its autograd backward)")
    return results


def flagship_routes_unchanged(device, model):
    """Phase 18: every GatedAttn of the flagship (C = 96) keeps the entry it
    had before the route: the proj entry at the 32-px levels, whose
    forward runs the projection GEMM and the tensor-core forward and whose
    backward runs the projection GEMM, the key-tiled dq and dK/dV kernels
    and the dseq and dW GEMMs (phases 4, 14 and 16 count one launch of
    each a proj call), and the long entry unpadded at the 64-px level 0,
    whose forward and gradients are the long kernels' on qkv = seq w^T,
    bit for bit."""
    from gpnf_tpu_torch.ops import kernels

    routes = {}
    for level, (_, h, w_) in zip(model.levels, model.level_shapes):
        attns = [m for m in level.modules() if type(m).__name__ == "GatedAttn"]
        routes[h * w_] = {tuple(m.route(h * w_)) for m in attns}
    routes[1024] = {tuple(attns[0].route(1024))}  # the 64-px level 0
    want = {256: {("proj", 24, 24)}, 64: {("proj", 24, 24)},
            16: {("proj", 24, 24)}, 1024: {("wide", 24, 24)}}
    log(f"  flagship GatedAttn routes by S: {routes}")
    if routes != want:
        raise AssertionError(f"flagship routes {routes} != {want}")
    gen = torch.Generator(device=device).manual_seed(97)
    seq = torch.randn((2, 1024, 96), generator=gen, device=device) * 0.5
    w = torch.randn((288, 96), generator=gen, device=device) * 0.1
    g = torch.randn((2, 1024, 96), generator=gen, device=device)
    seed = torch.tensor([11], dtype=torch.int32, device=device)
    seq_r, w_r = seq.clone().requires_grad_(), w.clone().requires_grad_()
    out = kernels.fused_attention_long(seq_r, w_r, 4, RATE, seed)
    out.backward(g)
    with torch.no_grad():
        qkv = torch.matmul(seq, w.t())
        dqkv = kernels.attention_long_qkv_bwd(qkv, g, 4, RATE, seed)
        same = (torch.equal(out, kernels.attention_long_qkv(qkv, 4, RATE,
                                                            seed))
                and torch.equal(seq_r.grad, torch.matmul(dqkv, w))
                and torch.equal(w_r.grad, torch.einsum("bso,bsc->oc", dqkv,
                                                       seq)))
    log(f"  64-px level 0 (S 1024, C 96, rate {RATE}): the wide route is the "
        f"long kernels on seq w^T, bit for bit: {same}")
    if not same:
        raise AssertionError("the unpadded wide route is not the long entry")
    return {str(k): sorted(v) for k, v in routes.items()}


def c512_runs(device):
    """One train step and one eval batch of the CLIs' default model at
    phase 18's depth and batch (random weights after ddi), for profile()."""
    from gpnf_tpu_torch.data.datasets import get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfFlow
    from gpnf_tpu_torch.train_marscf import model_config, parse_args
    from gpnf_tpu_torch.training.loop import train_step
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    model = MarScfFlow(model_config(parse_args(C512_ARGS)), device=device)
    batch = torch.from_numpy(next(iter(get_dataset(
        "synthetic", C512_BATCH)[0]))).to(device)
    model.ddi(batch, generator=torch.Generator(device=device).manual_seed(0))
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=C512_WARM_UP,
                       batch_size=C512_BATCH)

    def eval_batch(gen):
        return model.eval()(batch, generator=gen)

    return {"C=512 train step": (
        lambda gen: train_step(model.train(), opt, batch, gen), True),
        "C=512 eval batch": (eval_batch, False)}


def cli_default_width(device, out_dir, card):
    """Phase 18's drive: `python -m gpnf_tpu_torch.train_marscf` at its
    default --C 512 and --coupling mixlogcdf on the synthetic set (L 3,
    K 2, batch 16, 12 steps, a warmup of 4 batches, a loss record a step:
    the loop's LOG_EVERY set to 1 for the run),
    then `python -m gpnf_tpu_torch.eval_marscf` on its checkpoint: bits/dim
    over the test set and one sampling pass. The counts are set to 0 just
    before each and read just after."""
    from gpnf_tpu_torch import eval_marscf, train_marscf
    from gpnf_tpu_torch.data.datasets import get_dataset
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training import loop

    ckpt = os.path.abspath(os.path.join(out_dir, "checkpoints_c512"))
    log_path = os.path.abspath(os.path.join(out_dir, "train_c512.jsonl"))
    shutil.rmtree(ckpt, ignore_errors=True)
    if os.path.exists(log_path):
        os.remove(log_path)
    args = [*C512_ARGS, "--checkpoint_dir", ckpt]
    n_eval = len(get_dataset("synthetic", C512_BATCH)[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    log_every, loop.LOG_EVERY = loop.LOG_EVERY, 1
    try:
        train_marscf.main([*args, "--max_steps", str(C512_STEPS), "--warm_up",
                           str(C512_WARM_UP), "--log_path", log_path])
    finally:
        loop.LOG_EVERY = log_every
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    losses = [r["nll"] for r in records if "nll" in r]
    test_nll = [r["test_nll"] for r in records if "test_nll" in r]
    log(f"  train_marscf {' '.join(args)} --max_steps {C512_STEPS}: losses "
        f"{[round(x, 4) for x in losses]} bits/dim, test {test_nll}; "
        f"{train_s:.1f} s with ddi, eval and the checkpoint; peak "
        f"{peak / 2 ** 30:.3f} GiB [{card}]; launches {train_counts}")
    # every attention call's forward: the train steps, the eval at the end
    # of the run over the test set, and ddi's one pass; the backward
    # recomputes the projection (one more qkv GEMM a step's call)
    steps = C512_ATTN * C512_STEPS
    fwd = C512_ATTN * (C512_STEPS + n_eval + 1)
    if not (len(losses) == C512_STEPS
            and all(math.isfinite(x) for x in losses + test_nll)
            and statistics.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"C=512 train losses not finite and falling: "
                             f"{losses}, test {test_nll}")
    want = {**dict.fromkeys(train_counts, 0),
            "fused_attention_long": fwd, "attention_lanes": fwd,
            "attention_qkv_gemm": fwd + steps,
            "fused_attention_long_bwd": steps, "attention_lanes_bwd": steps,
            "attention_dseq_gemm": steps, "attention_dw_gemm": steps,
            "mixlogcdf_forward": fwd // 10}
    if train_counts != want:
        raise AssertionError(f"C=512 train launches {train_counts} != {want}")

    cwd = os.getcwd()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    os.chdir(out_dir)  # the CLI writes its grid under ./samples
    try:
        served = eval_marscf.main(args)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    log(f"  eval_marscf: test bits/dim {served['nll']:.4f} over {n_eval} "
        f"batches of {C512_BATCH}, {served['nan_count']} NaN before the "
        f"clamp, grid {served['samples']}; {eval_s:.1f} s; launches "
        f"{eval_counts}")
    passes = C512_ATTN * (n_eval + 1)  # every eval batch, one sampling pass
    want = {**dict.fromkeys(eval_counts, 0), "fused_attention_long": passes,
            "attention_lanes": passes, "attention_qkv_gemm": passes,
            "mixlogcdf_forward": 6 * n_eval,
            "mixture_inverse": 6}
    if not (math.isfinite(served["nll"]) and served["nll"] < 30.0
            and eval_counts == want):
        raise AssertionError(f"C=512 eval bits/dim {served['nll']} or "
                             f"launches {eval_counts} != {want}")
    shutil.rmtree(ckpt)  # ~1.9 GB of npz
    return {"losses": losses, "test_nll": test_nll, "train_s": train_s,
            "train_peak_memory_bytes": peak, "launches": train_counts,
            "eval_bits_per_dim": served["nll"], "eval_s": eval_s,
            "eval_launches": eval_counts, "nan_before_clamp":
                served["nan_count"]}

# -- phase 19: serving the flagship in bf16 --------------------------------------
# (batch, S, C) of the bf16 kernels' checks: the flagship's three levels, and
# the CLIs' C 512 at the 32-px level 0; the forward also at the 64-px level 0
BF16_GEMM_CASES = ((BATCH, 256, 96), (BATCH, 64, 96), (BATCH, 16, 96),
                   (C512_BATCH, 256, 512))
C1024_BATCH = 4  # Dh 256: the widest head the bf16 kernels are built for
BF16_FWD_CASES = BF16_GEMM_CASES[:3] + ((BATCH, 1024, 96),
                                        (C512_BATCH, 256, 512),
                                        (C1024_BATCH, 256, 1024))
BF16_FWD_BAR = 2.0 ** -7  # x max |v|: P's rounding and the output's
# the H100's special-function unit, ex2 results a second (the FlashAttention-3
# paper's figure): the bf16 forward takes one exponential a score
PEAK_EXP = 3.9e12
# latents decoded by the sampling path and re-encoded, against themselves:
# max abs diff over the largest |latent|, at each level. The bf16 nets see
# inputs that agree only to the inverse's error, so a bf16 cast may differ
# by one ulp (2^-8 relative), and 12 couplings compound it both ways: the
# port on the CPU recovered the latents of 4 and 16 test images within
# 1.1-1.7% (float32: 3.5e-6)
BF16_LATENT_BAR = 2.0 ** -4
BF16_EVAL = plus({"mixlogcdf_forward": 12, **proj_stages(120)},
                 attention_qkv_gemm_bf16=120, attention_fwd_bf16=120)
BF16_SAMPLE = plus({"mixture_inverse": 12, **proj_stages(120)},
                   attention_qkv_gemm_bf16=120, attention_fwd_bf16=120)


def _bf16_bound(bytes_moved, ops):
    """(least ms, "bytes" or "operations") at 3.35 TB/s and the dense bf16
    tensor-core rate."""
    return bound(bytes_moved, ops, PEAK_OPS_BF16)


def wgmma_fwd_sass():
    """{instantiation: {"hgmma": {opcode: n}, "tma": {opcode: n}}} of the
    bf16 attention forward on TMA + wgmma (cuobjdump -sass); raises unless
    each of its 12 instantiations (Dh 24, 128, 256, with and without
    dropout and the statistics' store) holds bf16 warpgroup products
    (HGMMA ... BF16) and TMA loads (UTMALDG)."""
    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops.kernels import _native

    out = {fn: {"hgmma": row["hgmma_ops"], "tma": row["tma_ops"]}
           for fn, row in sass_counts(
               _native.library_path("fused_attention_long")).items()
           if "attention_wgmma_fwd_kernel" in fn}
    log(f"  attention_wgmma_fwd_kernel: HGMMA and TMA instructions in the "
        f"SASS of each instantiation (cuobjdump -sass): {out}")
    if len(out) != 12 or not all(
            any("BF16" in op for op in row["hgmma"]) and row["tma"].get(
                "UTMALDG", 0) for row in out.values()):
        raise AssertionError(f"attention_wgmma_fwd_kernel: no bf16 HGMMA or "
                             f"UTMALDG in {out}")
    return out


def wgmma_sass():
    """{instantiation: {"hgmma": {opcode: n}, "tma": {opcode: n}}} of the
    bf16 GEMM's TMA + wgmma kernel (cuobjdump -sass); raises unless each of
    its 24 instantiations (3 layouts, 2 tile widths, bf16 or float32 c,
    clusters of 8 or 2) holds bf16 warpgroup products (HGMMA ... BF16) and
    TMA loads (UTMALDG)."""
    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops.kernels import _native

    out = {fn: {"hgmma": row["hgmma_ops"], "tma": row["tma_ops"]}
           for fn, row in sass_counts(
               _native.library_path("attention_gemm")).items()
           if "gemm_wgmma_bf16_kernel" in fn}
    log(f"  gemm_wgmma_bf16_kernel: HGMMA and TMA instructions in the SASS "
        f"of each instantiation (cuobjdump -sass): {out}")
    if len(out) != 24 or not all(
            any("BF16" in op for op in row["hgmma"]) and row["tma"].get(
                "UTMALDG", 0) for row in out.values()):
        raise AssertionError(f"gemm_wgmma_bf16_kernel: no bf16 HGMMA or "
                             f"UTMALDG in {out}")
    return out


def check_aligned_route(phase):
    """The bf16 GEMM's calls in this run so far all took the TMA + wgmma
    kernel: the unaligned route's count (never reset) is 0."""
    from gpnf_tpu_torch.ops import kernels

    n = kernels.attention_gemm_bf16_unaligned.launches
    log(f"  the bf16 GEMM's unaligned route: {n} launches through phase "
        f"{phase}")
    if n:
        raise AssertionError(f"phase {phase}: {n} bf16 GEMM calls took the "
                             f"unaligned route")
    return n


def check_bf16_kernels(device, timer, reports):
    """Phase 19's kernel checks: the bf16 qkv GEMM (within one bf16 ulp of
    its plain version plus the float32 sums' spread, `bf16_product_close`)
    and the bf16 tensor-core forward (within 2^-7 max |v|) at
    BF16_GEMM_CASES / BF16_FWD_CASES, rate 0 and 0.2 for the forward (one
    seed: the same mask; at S 1024 rate 0.2 compared at batch
    LONG_DROPOUT_BATCH), two calls bit for bit, one device launch a call,
    each with its time, the plain version's, the library call's
    (torch.matmul / SDPA on bf16) and its bound at the bf16 rate (the
    forward's exponentials beside it); the bf16 HGMMA and UTMALDG of each
    kernel's SASS and its ptxas registers and spills (none in the
    forward)."""
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
    gen = torch.Generator(device=device).manual_seed(1919)
    randn = lambda *shape, s=1.0: (torch.randn(
        shape, generator=gen, device=device) * s).to(torch.bfloat16)
    rows = {"attention_qkv_gemm_bf16": [], "attention_fwd_bf16": []}
    for b, s, c in BF16_GEMM_CASES:
        seq, w = randn(b, s, c, s=0.5), randn(3 * c, c, s=0.1)
        run = lambda: kernels.attention_qkv_gemm(seq, w)
        got = run()
        want = fa.bf16_matmul(seq, w.t())
        same = torch.equal(got, run())
        ok = fa.bf16_product_close(got, want, seq, w)
        err = float((got.float() - want.float()).abs().max())
        m, n, k = b * s, 3 * c, c
        plan = fa.gemm_bf16_plan(m, n, k, seq.data_ptr(), w.data_ptr(),
                                 got.data_ptr(), False, True, 1)
        launches = graph_launches(run)
        bound_ms, bound_by = _bf16_bound(2 * (m * k + n * k + m * n),
                                         2 * m * n * k)
        row = dict(shape=[b, s, c], max_abs_err=err, within_bar=ok,
                   plan=plan._asdict(), device_launches=launches,
                   ms=timer(run),
                   plain_ms=timer(lambda: fa.bf16_matmul(seq, w.t())),
                   library_ms=timer(lambda: torch.matmul(seq, w.t())),
                   bound_ms=bound_ms, bound_by=bound_by)
        rows["attention_qkv_gemm_bf16"].append(row)
        log(f"  bf16 qkv GEMM (B, S, C) {(b, s, c)}: max abs err {err:.3g} "
            f"within one bf16 ulp + the fp32 sums' spread: {ok}; two calls "
            f"bit for bit: {same}; {plan.route} route, tile 128 x "
            f"{plan.tile}, {plan.splits} split(s), {plan.stages} stages, "
            f"{launches} device launch(es) | kernel {row['ms']:.4f} ms plain "
            f"{row['plain_ms']:.4f} ms torch.matmul (bf16) "
            f"{row['library_ms']:.4f} ms | bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
        if not (ok and same and plan.route == "wgmma" and launches == 1):
            raise AssertionError(f"bf16 qkv GEMM {(b, s, c)}: within bar "
                                 f"{ok}, repeat {same}, {plan}, {launches} "
                                 f"device launches")
    seed = torch.tensor([19], dtype=torch.int32, device=device)
    for b, s, c in BF16_FWD_CASES:
        heads, dh = 4, c // 4
        qkv = randn(b, s, 3 * c)
        for rate in (0.0, RATE):
            run = lambda: kernels.attention_long_qkv(qkv, heads, rate, seed)
            got = run()
            same = torch.equal(got, run())
            launches = graph_launches(run)
            # training's forward: the same out, and the (m, 1/l) it keeps
            # for the backward against the plain statistics
            with_stats = lambda: kernels.attention_long_qkv(
                qkv, heads, rate, seed, with_stats=True)
            out_st, stats = with_stats()
            same_stats_off = torch.equal(out_st, got)
            st_plain = fa.attention_stats_plain(qkv, heads)
            stats_err = [float((stats[..., 0] - st_plain[..., 0]).abs().max()),
                         float(((stats[..., 1] - st_plain[..., 1])
                                / st_plain[..., 1]).abs().max())]
            sub = (b if rate == 0.0 or s <= 256 else LONG_DROPOUT_BATCH)
            want = kernels.attention_long_plain(qkv[:sub], heads, rate, seed)
            err = float((got[:sub].float() - want.float()).abs().max())
            bar = BF16_FWD_BAR * float(qkv[..., c:2 * c].float().abs().max())
            bound_ms, bound_by = _bf16_bound(2 * b * s * 4 * c,
                                             4 * b * heads * s * s * dh)
            row = dict(shape=[b, s, c], head_dim=dh, rate=rate,
                       max_abs_err=err, bar=bar, ms=timer(run),
                       stats_ms=timer(with_stats),
                       same_bits_with_stats=same_stats_off,
                       stats_err_m_and_rel_inv_l=stats_err,
                       device_launches=launches,
                       bound_ms=bound_ms, bound_by=bound_by,
                       exp_bound_ms=b * heads * s * s / PEAK_EXP * 1e3)
            if sub == b:
                row["plain_ms"] = timer(lambda: kernels.attention_long_plain(
                    qkv, heads, rate, seed))
            if rate == 0.0:
                k_, v_, q_ = (t.reshape(b, s, heads, dh).transpose(1, 2)
                              for t in qkv.split(c, dim=-1))
                row["library_ms"] = timer(
                    lambda: F.scaled_dot_product_attention(q_, k_, v_))
            rows["attention_fwd_bf16"].append(row)
            log(f"  bf16 forward (B, S, C) {(b, s, c)}, Dh {dh}, rate {rate}"
                f": max abs err {err:.3g} (bar {bar:.3g}; compared at batch "
                f"{sub}); two calls bit for bit: {same}; with the "
                f"statistics' store out bit for bit the same: "
                f"{same_stats_off}, (m, 1/l) against the plain statistics: "
                f"max abs {stats_err[0]:.3g}, max rel {stats_err[1]:.3g}, "
                f"{launches} device launch(es) | "
                f"kernel {row['ms']:.4f} ms ({row['stats_ms']:.4f} with the "
                f"statistics) plain {row.get('plain_ms', float('nan')):.4f} ms"
                + (f" SDPA (bf16) {row['library_ms']:.4f} ms"
                   if rate == 0.0 else "")
                + f" | bound {bound_ms * 1e3:.2f} us ({bound_by}; one "
                f"exponential a score {row['exp_bound_ms'] * 1e3:.2f} us)")
            if not (err <= bar and same and same_stats_off
                    and stats_err[0] <= BF16_STATS_BAR
                    and stats_err[1] <= BF16_STATS_BAR and launches == 1):
                raise AssertionError(
                    f"bf16 forward {(b, s, c)} rate {rate}: err {err} > {bar}"
                    f", repeat {same}, out with the statistics "
                    f"{same_stats_off}, statistics {stats_err} > "
                    f"{BF16_STATS_BAR} or {launches} device launches")
    sass = {"gemm_wgmma_bf16_kernel": wgmma_sass(),
            "attention_wgmma_fwd_kernel": wgmma_fwd_sass()}
    ptxas = {"attention_qkv_gemm_bf16": ptxas_kernels(
                 reports.get("attention_gemm", ""), "gemm_wgmma_bf16_kernel"),
             "attention_fwd_bf16": ptxas_kernels(
                 reports.get("fused_attention_long", ""),
                 "attention_wgmma_fwd_kernel")}
    log(f"  ptxas: {ptxas}")
    spilled = [r["kernel"] for r in ptxas["attention_fwd_bf16"]
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        raise AssertionError(f"attention_wgmma_fwd_kernel spills in {spilled}")
    return rows, {"sass_bf16_hmma": sass, "ptxas": ptxas}


def _decode(model, latents):
    """The sampling path (`MarScfFlow.sample`'s inverse) from given latents
    {level: latent}, level L the top one, level i < L the split-off half of
    level i, in place of the prior's draws."""
    cfg = model.cfg
    z = latents[cfg.L]
    zero = torch.zeros((z.shape[0],), device=z.device)
    for i in reversed(range(cfg.L)):
        if i < cfg.L - 1:
            z = torch.cat([z, latents[i + 1]], dim=1)
        z, _ = model.levels[i].inverse(z, zero)
        z, _ = model.squeeze.inverse(z, zero)
    return z


def _reencode(model, x):
    """{level: latent} of the flow's forward on x (no dequantisation)."""
    zero = torch.zeros((x.shape[0],), device=x.device)
    out, z = {}, x
    for i, level in enumerate(model.levels):
        z, _ = level(*model.squeeze.forward(z, zero))
        if i < model.cfg.L - 1:
            z, out[i + 1] = z[:, : z.shape[1] // 2], z[:, z.shape[1] // 2:]
    out[model.cfg.L] = z
    return out


def _eval_timed(model, loader, device, seed):
    """(bits/dim, seconds) of one eval pass."""
    from gpnf_tpu_torch.training.loop import evaluate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nll = evaluate(model, loader, generator=torch.Generator(
        device=device).manual_seed(seed))
    return nll, time.perf_counter() - t0


def bf16_flagship(device, model, loader, proto, nll32, out_dir, seed, card):
    """Phase 19's flagship: phase 5's weights in a compute_dtype="bfloat16"
    model (eval mode): bits/dim over phase 5's batches and noise with exact
    launch counts, its gap to phase 5's float32 bits/dim, one proj forward's
    device launches (a CUDA graph), a sampling pass (every image finite),
    the sampling path's inverse from the latents of a test batch re-encoded
    (the prior's samples of random weights reach 1e6 and re-encode to NaN
    in float32 too, so the latents are the data's), card vs the port on the
    CPU at batch 2, eval images/s in bf16 and float32 in turns, peak
    memory."""
    import dataclasses

    from gpnf_tpu_torch.models.marscf import MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import save_sample_grid
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    cfg16 = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    m16 = MarScfFlow(cfg16, device=device).eval()
    m16.load_state_dict(model.state_dict())
    n_batches = len(loader)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    nll16, _ = _eval_timed(m16, loader, device, seed + 1)
    eval_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    want = {k: BF16_EVAL.get(k, 0) * n_batches for k in eval_counts}
    log(f"  bf16 eval bits/dim {nll16:.6f} over {n_batches} batches of "
        f"{BATCH} (float32, phase 5: {nll32:.6f}; bf16 - float32 "
        f"{nll16 - nll32:+.6f}); peak device memory {peak / 2 ** 30:.3f} GiB "
        f"[{card}]; launches {eval_counts}")
    if eval_counts != want or not (math.isfinite(nll16) and nll16 < 30.0):
        raise AssertionError(f"bf16 eval: {nll16}, launches {eval_counts} "
                             f"!= {want}")
    attn = m16.levels[0].steps[0].coupling.net.blocks[0].attn
    with torch.no_grad():
        w16 = attn.in_proj.effective_weight(torch.bfloat16).contiguous()
        seq = (torch.randn((BATCH, 256, 96), generator=torch.Generator(
            device=device).manual_seed(seed + 3), device=device) * 0.5).to(
                torch.bfloat16)
        device_launches = graph_launches(
            lambda: kernels.fused_attention_proj(seq, w16, attn.num_heads))
    log(f"  one bf16 proj forward at level 0: {device_launches} device "
        f"launches (the qkv GEMM, the forward)")
    if device_launches != 2:
        raise AssertionError(f"bf16 proj forward: {device_launches} device "
                             f"launches, want 2")

    kernels.reset_launch_counts()
    path, nan_count = save_sample_grid(
        m16, os.path.join(out_dir, "samples_bf16.png"), n=BATCH,
        generator=torch.Generator(device=device).manual_seed(seed + 2))
    sample_counts = kernels.launch_counts()
    want = {k: BF16_SAMPLE.get(k, 0) for k in sample_counts}
    log(f"  bf16 sampling pass: wrote {path}; {nan_count} NaN before the "
        f"clamp; launches {sample_counts}")
    if sample_counts != want or nan_count:
        raise AssertionError(f"bf16 sampling: {nan_count} NaN, launches "
                             f"{sample_counts} != {want}")
    x = m16.dequantize(torch.from_numpy(next(iter(loader))).to(device),
                       generator=torch.Generator(device=device).manual_seed(
                           seed + 4))
    with torch.no_grad():
        latents = _reencode(m16, x)
        x_back = _decode(m16, latents)
        again = _reencode(m16, x_back)
    latent_err = {lv: float((again[lv] - latents[lv]).abs().max()
                            / latents[lv].abs().max()) for lv in latents}
    x_err = float((x_back - x).abs().max())
    log(f"  bf16: a test batch's latents through the sampling path and "
        f"re-encoded: max abs diff / max |latent| by level {latent_err} "
        f"(bar {BF16_LATENT_BAR}); the decoded images' max abs diff "
        f"{x_err:.3g}")
    if not all(v <= BF16_LATENT_BAR for v in latent_err.values()):
        raise AssertionError(f"bf16 latents not recovered: {latent_err}")
    # card vs the port on the CPU at batch 2, the same weights and noise;
    # the bar is the larger of 1e-3 and half of the bf16-vs-float32 gap the
    # CPU itself shows on them
    xb = torch.from_numpy(proto[:2])
    noise = torch.rand(xb.shape, generator=torch.Generator().manual_seed(19))
    cpu16 = MarScfFlow(cfg16, device="cpu").eval()
    cpu16.load_state_dict(model.state_dict())
    cpu32 = MarScfFlow(model.cfg, device="cpu").eval()
    cpu32.load_state_dict(model.state_dict())
    with torch.no_grad():
        card_bpd = m16(xb.to(device), noise=noise.to(device))[1].cpu()
        cpu_bpd = cpu16(xb, noise=noise)[1]
        cpu32_bpd = cpu32(xb, noise=noise)[1]
    del cpu16, cpu32
    diff = float((card_bpd - cpu_bpd).abs().max())
    cpu_gap = float((cpu_bpd - cpu32_bpd).abs().max())
    bar = max(1e-3, 0.5 * cpu_gap)
    log(f"  bf16 card vs CPU at batch 2: bits/dim card {card_bpd.tolist()} "
        f"CPU {cpu_bpd.tolist()} (max diff {diff:.3g}, bar {bar:.3g}: the "
        f"larger of 1e-3 and half the CPU's bf16-vs-float32 gap "
        f"{cpu_gap:.3g})")
    if not (torch.isfinite(card_bpd).all() and diff <= bar):
        raise AssertionError(f"bf16 card vs CPU {diff} > {bar}")

    # eval images/s, float32 and bf16 in turns on the same weights and
    # batches, median of 3
    times = {"float32": [], "bfloat16": []}
    for i in range(3):
        for name, net in (("float32", model), ("bfloat16", m16)):
            times[name].append(_eval_timed(net, loader, device,
                                           seed + 30 + i)[1])
    ips = {k: n_batches * BATCH / statistics.median(v)
           for k, v in times.items()}
    log(f"  eval images/s (median of 3 passes over {n_batches * BATCH} "
        f"images, in turns): float32 {ips['float32']:.1f}, bf16 "
        f"{ips['bfloat16']:.1f} ({times}) [{card}]")
    return {"eval_bits_per_dim": nll16, "float32_eval_bits_per_dim": nll32,
            "bf16_minus_float32": nll16 - nll32, "eval_launches": eval_counts,
            "sample_launches": sample_counts,
            "proj_device_launches": device_launches,
            "sample_nan_count": nan_count, "latent_rel_err": latent_err,
            "decoded_max_abs_err": x_err, "card_vs_cpu": diff,
            "card_vs_cpu_bar": bar, "cpu_bf16_vs_float32": cpu_gap,
            "eval_images_per_s": ips, "eval_s": times,
            "eval_peak_memory_bytes": peak}


def bf16_other_models(device, seed, card):
    """Phase 19's other widths in bf16, one eval batch each on random
    weights after ddi, beside the float32 model on the same weights and
    batch: the 64-px row (phase 14's configuration; level 0 the long entry
    at S 1024, its projection a plain product) and phase 18's --C 512
    model (L 3, K 2, batch 16; the wide route at Dh 128), with exact launch
    counts."""
    import dataclasses

    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.train_marscf import model_config, parse_args

    out = {}
    c512 = model_config(parse_args(C512_ARGS))
    cases = (("imagenet64", MarScfConfig(**IMAGENET64), BATCH, plus(
                 {"mixlogcdf_forward": 12, **proj_stages(80)},
                 fused_attention_long=40, attention_qkv_gemm_bf16=80,
                 attention_fwd_bf16=120)),
             ("c512", c512, C512_BATCH, {
                 "fused_attention_long": C512_ATTN, "attention_qkv_gemm":
                 C512_ATTN, "attention_qkv_gemm_bf16": C512_ATTN,
                 "attention_fwd_bf16": C512_ATTN, "mixlogcdf_forward": 6}))
    for name, cfg, batch, per_batch in cases:
        t0 = time.perf_counter()
        raw = get_dataset("imagenet_64" if name == "imagenet64" else
                          "synthetic", batch, seed=seed)[1].images[:batch]
        loader = NumpyLoader(raw, batch, shuffle=False)
        model = MarScfFlow(cfg, device=device, generator=torch.Generator(
            ).manual_seed(seed + 60)).eval()
        model.ddi(torch.from_numpy(next(iter(loader))).to(device),
                  generator=torch.Generator(device=device).manual_seed(
                      seed + 61))
        m16 = MarScfFlow(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                         device=device).eval()
        m16.load_state_dict(model.state_dict())
        nll32, _ = _eval_timed(model, loader, device, seed + 62)
        kernels.reset_launch_counts()
        nll16, eval_s = _eval_timed(m16, loader, device, seed + 62)
        counts = kernels.launch_counts()
        want = {k: per_batch.get(k, 0) for k in counts}
        log(f"  {name} in bf16: one eval batch of {batch}, bits/dim "
            f"{nll16:.6f} (float32 on the same weights {nll32:.6f}, bf16 - "
            f"float32 {nll16 - nll32:+.6f}), {eval_s:.3f} s with the first "
            f"call's setup [{card}]; launches {counts}; phase took "
            f"{time.perf_counter() - t0:.1f} s")
        if counts != want or not (math.isfinite(nll16) and nll16 < 30.0):
            raise AssertionError(f"{name} bf16 eval: {nll16}, launches "
                                 f"{counts} != {want}")
        out[name] = {"eval_bits_per_dim": nll16,
                     "float32_eval_bits_per_dim": nll32,
                     "eval_launches": counts}
        del model, m16
        torch.cuda.empty_cache()
    return out


# -- phase 20: training the flagship in bf16 --------------------------------------
# (batch, S, C) of the bf16 backward's checks: the flagship's three levels
# (the proj entry: dq scaled in float32), the 64-px level 0 and the CLIs'
# C 512 at the 32-px level 0 (the long entry: dq rounded, then scaled in
# bf16)
BF16_BWD_CASES = BF16_GEMM_CASES[:3] + ((BATCH, 1024, 96),
                                        (C512_BATCH, 256, 512))
# every other width in HEAD_DIMS at one shape: Dh 4, 8, 16 (run 24 wide),
# 32, 48, 64 (run 128 wide) and 256 (C 1024), batch 4, S 256
BF16_WIDTHS = (4, 8, 16, 32, 48, 64, 256)
BF16_WIDTH_SHAPE = (4, 256)
BF16_BWD_BAR = 2.0 ** -7  # x max |plain| of each third of dqkv
# the forward's (m, 1/l) against `attention_stats_plain`: m's max abs
# difference and 1/l's max relative one (float32 sums of the same scores
# in another order)
BF16_STATS_BAR = 1e-4
# device launches of one bf16 backward call given the forward's statistics,
# at a width the kernels are built for (a padded width adds the wrapper's
# pad and slice copies)
BF16_BWD_LAUNCHES = 2
# the float32 spread of dW's sums: K 2^-24 sum_k |a_ik b_kj| (two orders)
BF16_TRAIN_WINDOWS, BF16_TRAIN_WINDOW_STEPS = 2, 5
# the card's bf16 gradient no further from the CPU's float32 one, in L2
# over every parameter, than this times the CPU's bf16 gradient is (0.99
# to 1.00 on an H100 80GB HBM3, PERF.md)
BF16_GRAD_L2_BAR = 1.5
# one bf16 train step at a padded width: the flagship at C 192 (Dh 48, run
# 128 wide; the wide route at level 0, the proj entry at levels 1 and 2)
C192 = dict(FLAGSHIP, hidden_channels=192)


def bf16_step_counts(n_attn, n_proj, n_couplings):
    """The launches of one bf16 train step (forward and backward) with
    n_attn GatedAttn calls at S <= 512, n_proj of them on the proj entry,
    and n_couplings MixLogCDF couplings: each call's projection (forward,
    and recomputed in the backward), attention forward and backward, dseq
    and dW, each on a bf16 kernel."""
    return plus({"mixlogcdf_forward": n_couplings, "mixture_inverse": 0,
                 **NO_GP, **NO_FGC, **NO_CORE, **NO_WIDE,
                 **proj_stages(n_proj, n_proj)},
                fused_attention_long=n_attn - n_proj,
                fused_attention_long_bwd=n_attn - n_proj,
                attention_qkv_gemm=2 * (n_attn - n_proj),
                attention_dseq_gemm=n_attn - n_proj,
                attention_dw_gemm=n_attn - n_proj,
                attention_qkv_gemm_bf16=2 * n_attn,
                attention_fwd_bf16=n_attn, attention_bwd_bf16=n_attn,
                attention_dseq_gemm_bf16=n_attn,
                attention_dw_gemm_bf16=n_attn)


BF16_TRAIN = bf16_step_counts(120, 120, 12)


def check_bf16_train_kernels(device, timer, reports):
    """Phase 20's kernel checks: the bf16 dq and dK/dV pair against the
    plain bf16 backward (each third of dqkv within 2^-7 of its largest
    |plain|) at BF16_BWD_CASES, rate 0 and 0.2 (one seed: the same mask; at
    S 1024 rate 0.2 compared at batch LONG_DROPOUT_BATCH), with each
    entry's recipe for dq; the forward and the backward at every other
    width (BF16_WIDTHS, padded by the wrappers) at rate 0.2; the bf16 GEMM's
    dseq (within one bf16 ulp plus the float32 sums' spread) and dW (float32,
    within the spread of two orders of its float32 sums) at
    BF16_GEMM_CASES; two calls bit for bit each; times, the plain
    versions', the library calls' (SDPA's autograd backward and
    torch.matmul, on bf16) and bounds at the bf16 rate; bf16 HMMA in the
    SASS of the new kernels and their ptxas registers and spills."""
    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.ops.kernels import _native
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
    gen = torch.Generator(device=device).manual_seed(2020)
    randn = lambda *shape, s=1.0: (torch.randn(
        shape, generator=gen, device=device) * s).to(torch.bfloat16)
    rows = {"attention_bwd_bf16": [], "attention_dseq_gemm_bf16": [],
            "attention_dw_gemm_bf16": [], "attention_fwd_bf16_widths": []}
    seed = torch.tensor([20], dtype=torch.int32, device=device)

    def heads_of(x, dh, grad=False):
        b, s, _ = x.shape
        x = x.reshape(b, s, -1, dh).transpose(1, 2).contiguous()
        return x.requires_grad_() if grad else x

    def sdpa_bwd_ms(qkv, g, dh):
        """Autograd backward of SDPA on bf16 heads, the graph built once
        and its backward timed alone."""
        k, v, q = (heads_of(t_, dh, True) for t_ in qkv.chunk(3, -1))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), heads_of(
            g, dh), retain_graph=True))

    def thirds_err(got, want, c):
        return [float((got[..., i * c:(i + 1) * c].float() -
                       want[..., i * c:(i + 1) * c].float()).abs().max() /
                      want[..., i * c:(i + 1) * c].float().abs().max())
                for i in range(3)]

    def bwd_case(b, s, c, rate, timed):
        heads, dh = 4, c // 4
        in_fp32 = kernels.attention_route(s, c, heads).entry == "proj"
        qkv, g = randn(b, s, 3 * c), randn(b, s, c, s=0.5)
        # the pair as training runs it, from the forward's statistics
        _, stats = kernels.attention_long_qkv(qkv, heads, rate, seed,
                                              with_stats=True)
        run = lambda: kernels.attention_long_qkv_bwd(
            qkv, g, heads, rate, seed, scale_dq_in_fp32=in_fp32,
            stats=stats)
        got = run()
        same = torch.equal(got, run())
        launches = graph_launches(run)
        sub = b if rate == 0.0 or s <= 256 else LONG_DROPOUT_BATCH
        plain = lambda: kernels.attention_long_plain_bwd(
            qkv[:sub], g[:sub], heads, rate, seed, None, in_fp32)
        errs = thirds_err(got[:sub], plain(), c)
        # the backward's five S x S x Dh products at the true width; qkv,
        # g and the forward's float32 (m, 1/l) in, dqkv out
        bound_ms, bound_by = _bf16_bound(2 * b * s * 7 * c + 8 * b * heads * s,
                                         10 * b * heads * s * s * dh)
        built = dh in fa.BF16_HEAD_DIMS
        row = dict(shape=[b, s, c], head_dim=dh, rate=rate,
                   dq_recipe="fp32" if in_fp32 else "bf16",
                   max_abs_err=max(errs), rel_err_dk_dv_dq=errs,
                   bar=BF16_BWD_BAR, device_launches=launches,
                   bound_ms=bound_ms, bound_by=bound_by)
        if timed:
            row["ms"] = timer(run)
            if sub == b:
                row["plain_ms"] = timer(plain)
            if rate == 0.0:
                row["library_ms"] = sdpa_bwd_ms(qkv, g, dh)
        log(f"  bf16 dq and dK/dV (B, S, C) {(b, s, c)}, Dh {dh}, rate "
            f"{rate}, dq {row['dq_recipe']}: max |got - plain| / max |plain| "
            f"dK dV dq {[f'{e:.3g}' for e in errs]} (bar {BF16_BWD_BAR:.3g}; "
            f"compared at batch {sub}); two calls bit for bit: {same}; "
            f"{launches} device launches a call"
            + ("" if built else " (the padding's copies beside the pair)")
            + (f" | kernel {row['ms']:.4f} ms plain "
               f"{row.get('plain_ms', float('nan')):.4f} ms"
               + (f" SDPA backward (bf16) {row['library_ms']:.4f} ms"
                  if rate == 0.0 else "") if timed else "")
            + f" | bound {bound_ms * 1e3:.2f} us ({bound_by})")
        if not (max(errs) <= BF16_BWD_BAR and same
                and (launches == BF16_BWD_LAUNCHES or not built)):
            raise AssertionError(f"bf16 backward {(b, s, c)} rate {rate}: "
                                 f"errs {errs}, repeat {same} or {launches} "
                                 f"device launches")
        return row

    for b, s, c in BF16_BWD_CASES:
        for rate in (0.0, RATE):
            rows["attention_bwd_bf16"].append(bwd_case(b, s, c, rate, True))
    b, s = BF16_WIDTH_SHAPE
    for dh in BF16_WIDTHS:
        c = 4 * dh
        rows["attention_bwd_bf16"].append(bwd_case(b, s, c, RATE, False))
        qkv = randn(b, s, 3 * c)
        run = lambda: kernels.attention_long_qkv(qkv, 4, RATE, seed)
        got = run()
        same = torch.equal(got, run())
        err = float((got.float() - kernels.attention_long_plain(
            qkv, 4, RATE, seed).float()).abs().max())
        bar = BF16_FWD_BAR * float(qkv[..., c:2 * c].float().abs().max())
        rows["attention_fwd_bf16_widths"].append(dict(
            shape=[b, s, c], head_dim=dh,
            kernel_head_dim=fa.padded_head_dim(dh, fa.BF16_HEAD_DIMS), rate=RATE,
            max_abs_err=err, bar=bar))
        log(f"  bf16 forward (B, S, C) {(b, s, c)}, Dh {dh} (run "
            f"{fa.padded_head_dim(dh, fa.BF16_HEAD_DIMS)} wide), rate {RATE}: max abs err "
            f"{err:.3g} (bar {bar:.3g}); two calls bit for bit: {same}")
        if not (err <= bar and same):
            raise AssertionError(f"bf16 forward at Dh {dh}: {err} > {bar} or "
                                 f"repeat {same}")

    for b, s, c in BF16_GEMM_CASES:
        seq, w, dqkv = randn(b, s, c, s=0.5), randn(3 * c, c, s=0.1), randn(
            b, s, 3 * c, s=0.1)
        d2, s2 = dqkv.reshape(-1, 3 * c), seq.reshape(-1, c)
        for name, run, plain, library, a_, b_, m, n, k, out_bytes in (
                ("attention_dseq_gemm_bf16",
                 lambda: kernels.attention_dseq_gemm(dqkv, w),
                 lambda: fa.bf16_matmul(dqkv, w),
                 lambda: torch.matmul(dqkv, w), d2, w.t(), b * s, c, 3 * c,
                 2),
                ("attention_dw_gemm_bf16",
                 lambda: kernels.attention_dw_gemm(dqkv, seq),
                 lambda: fa.dw_plain(dqkv, seq),
                 lambda: torch.matmul(d2.t(), s2), d2.t(), s2.t(), 3 * c, c,
                 b * s, 4)):
            got = run()
            same = torch.equal(got, run())
            want = plain()
            # dW's error over sum |products| against the float64 product,
            # the plain version's beside it (K = B S = 16,384 at level 0)
            f64 = {}
            if name == "attention_dseq_gemm_bf16":
                ok = fa.bf16_product_close(got, want, a_, b_)
            else:
                spread = k * 2.0 ** -24 * (a_.float().abs() @
                                           b_.float().abs().t())
                ok = bool(((got - want).abs() <= spread).all())
                exact = a_.double() @ b_.double().t()
                mag = (a_.double().abs() @ b_.double().abs().t()).clamp_min(
                    1e-30)
                f64 = {"err_over_sum_abs": float(
                           ((got.double() - exact).abs() / mag).max()),
                       "plain_err_over_sum_abs": float(
                           ((want.double() - exact).abs() / mag).max()),
                       "bar_over_sum_abs": k * 2.0 ** -24}
            err = float((got.float() - want.float()).abs().max())
            plan = fa.gemm_bf16_plan(m, n, k, a_.data_ptr(), b_.data_ptr(),
                                     got.data_ptr(), name.endswith("dw_gemm_bf16"),
                                     False)
            launches = graph_launches(run)
            bound_ms, bound_by = _bf16_bound(
                2 * (m * k + n * k) + out_bytes * m * n, 2 * m * n * k)
            row = dict(shape=[b, s, c], plan=plan._asdict(),
                       splits=plan.splits, device_launches=launches,
                       max_abs_err=err, within_bar=ok, **f64, ms=timer(run),
                       plain_ms=timer(plain), library_ms=timer(library),
                       bound_ms=bound_ms, bound_by=bound_by)
            rows[name].append(row)
            log(f"  bf16 {name.split('_')[1]} GEMM (B, S, C) {(b, s, c)}, "
                f"{plan.route} route, tile 128 x {plan.tile}, "
                f"{plan.splits} split(s) of {plan.per} k-blocks, "
                f"{launches} device launch(es), {got.dtype}: max abs err "
                f"{err:.3g} within bar: {ok}; two calls bit for bit: {same}"
                + (f"; against float64: {f64['err_over_sum_abs']:.3g} of "
                   f"sum |products| (plain "
                   f"{f64['plain_err_over_sum_abs']:.3g}, bar "
                   f"{f64['bar_over_sum_abs']:.3g})" if f64 else "")
                + f" | kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                f" ms torch.matmul (bf16) {row['library_ms']:.4f} ms | bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by})")
            if not (ok and same and plan.route == "wgmma" and launches == 1):
                raise AssertionError(f"{name} {(b, s, c)}: within bar {ok}, "
                                     f"repeat {same}, {plan}, {launches} "
                                     f"device launches")
    sass = {"gemm_wgmma_bf16_kernel": wgmma_sass()}
    for pattern in ("attention_bf16_dq_kernel", "attention_bf16_dkv_kernel"):
        source = "fused_attention_long"
        hmma = {fn: row["hmma_ops"].get("HMMA.16816.F32.BF16", 0)
                for fn, row in sass_counts(
                    _native.library_path(source)).items() if pattern in fn}
        sass[pattern] = hmma
        log(f"  {pattern}: HMMA.16816.F32.BF16 instructions in the SASS of "
            f"each instantiation (cuobjdump -sass): {hmma}")
        if not hmma or not all(hmma.values()):
            raise AssertionError(f"{pattern}: no bf16 HMMA in {hmma}")
    ptxas = {"attention_bwd_bf16": ptxas_kernels(
                 reports.get("fused_attention_long", ""), "attention_bf16_d"),
             "gemm_wgmma_bf16_kernel": ptxas_kernels(
                 reports.get("attention_gemm", ""), "gemm_wgmma_bf16_kernel")}
    log(f"  ptxas: {ptxas}")
    return rows, {"sass_bf16_hmma": sass, "ptxas": ptxas}


def _settled_memory(device):
    """The device memory allocated once the garbage of earlier phases is
    collected, with the peak reset: what a phase's peak stands on."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _bf16_train_model(cfg, device, batches, seed):
    """(model, optimizer, step function) of phase 4's seeds: the weights
    from seed + 10, ddi on the first batch, dropout noise from seed + 11."""
    from gpnf_tpu_torch.models.marscf import MarScfFlow
    from gpnf_tpu_torch.training.loop import train_step
    from gpnf_tpu_torch.training.optim import AdamaxWarmup

    model = MarScfFlow(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed + 10))
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    model.ddi(batches[0], generator=gen)
    model.train()
    opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=WARM_UP,
                       batch_size=batches[0].shape[0])
    step = [0]

    def one_step():
        loss = train_step(model, opt, batches[step[0] % len(batches)], gen)
        step[0] += 1
        return loss

    return model, opt, one_step


@contextlib.contextmanager
def gated_conv_through_plain():
    """A probe, not a path of the system: inside it the fused GatedConv's
    autograd function computes its plain versions (`gated_conv_plain`,
    `gated_conv_plain_bwd`) on the card in place of the kernels."""
    fgc = importlib.import_module(
        "gpnf_tpu_torch.ops.kernels.fused_gated_conv")
    saved = fgc._forward, fgc.fused_gated_conv_bwd
    fgc._forward, fgc.fused_gated_conv_bwd = (fgc.gated_conv_plain,
                                              fgc.gated_conv_plain_bwd)
    try:
        yield
    finally:
        fgc._forward, fgc.fused_gated_conv_bwd = saved


def bf16_card_vs_cpu_step(model, x, device, config, noise_seed,
                          probe_plain_gated_conv=False):
    """One training step at dropout 0 on `model`'s weights in bf16 on the
    card and on the CPU, in float32 on the CPU, and in bf16 on the card and
    on the CPU on weights moved by 2^-22 (two draws), the same images and
    noise: the card's loss minus the CPU bf16 loss on the same weights,
    averaged over the three weight draws, within the larger of 1e-3
    bits/dim and half the CPU's bf16-vs-float32 gap (a weight move of
    2^-22 moves one draw's bf16 loss by as much as the bar's order; a
    fault of the card's moves all three draws); every gradient tensor (on the
    unmoved weights) within its own bar (`grad_parity`: the
    larger of 1e-3 of its largest float32 value and 3 times its CPU bf16
    noise, a tensor under 12 elements held to the noise pooled over its
    namesakes); the whole gradient's L2 distance from the CPU's float32 one
    at most BF16_GRAD_L2_BAR times the CPU bf16's. probe_plain_gated_conv:
    the same step once more on the card with the fused GatedConv's plain
    versions in place of its kernels (`gated_conv_through_plain`), logged
    beside the card's, not held to a bar: which part of the card's distance
    from the CPU stays with the kernels."""
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.utils import grad_parity

    noise = torch.rand(x.shape,
                       generator=torch.Generator().manual_seed(noise_seed))
    step = {}
    probe = (("card_plain_gconv", device, "bfloat16", model.state_dict()),
             ) if probe_plain_gated_conv else ()
    for name, dev, dtype, weights in (
            ("card", device, "bfloat16", model.state_dict()),
            ("cpu16", "cpu", "bfloat16", model.state_dict()),
            ("cpu32", "cpu", "float32", model.state_dict()),
            *((f"{run}{i}", dev, "bfloat16", grad_parity.perturbed(model, i))
              for i in (1, 2)
              for run, dev in (("moved", "cpu"), ("card_moved", device))),
            *probe):
        net = MarScfFlow(MarScfConfig(**{**config, "drop_prob": 0.0,
                                         "compute_dtype": dtype}), device=dev)
        net.load_state_dict(weights)
        with (gated_conv_through_plain() if name == "card_plain_gconv"
              else contextlib.nullcontext()):
            loss = torch.mean(net(x.to(dev), noise=noise.to(dev))[1])
            loss.backward()
        step[name] = (float(loss.detach()), {
            k: p.grad.detach().float().cpu() for k, p in
            net.named_parameters()})
        del net
    (card, g16), (cpu16, c16), (cpu32, c32) = (step["card"], step["cpu16"],
                                               step["cpu32"])
    gap = abs(cpu16 - cpu32)
    loss_bar = max(1e-3, 0.5 * gap)
    # card minus CPU bf16 on each of the three weight draws, and their mean
    paired = [card - cpu16] + [step[f"card_moved{i}"][0] - step[f"moved{i}"][0]
                               for i in (1, 2)]
    loss_diff = abs(statistics.mean(paired))
    rows = grad_parity.bf16_grad_parity(
        g16, c16, c32, [step["moved1"][1], step["moved2"][1]])
    # the same rule for a bf16 run the CPU made: the first moved draw
    # against the reference, with the second as its only other draw
    cpu_rows = grad_parity.bf16_grad_parity(step["moved1"][1], c16, c32,
                                            [step["moved2"][1]])
    # why one-element tensors are pooled: over a single gap of its own,
    # the card's and a moved CPU run's distance from the reference
    single = {run: max((float((g[k] - c16[k]).abs().max()) / max(
                            float((c16[k] - c32[k]).abs().max()), 1e-30), k)
                       for k in c32 if c32[k].numel() == 1)
              for run, g in (("card", g16), ("moved", step["moved1"][1]))}
    l2 = lambda a: math.sqrt(sum(float(((a[k] - c32[k]) ** 2).sum())
                                 for k in c32))
    l2_ratio = l2(g16) / l2(c16)
    finite = all(torch.isfinite(g).all() for g in g16.values())
    median = statistics.median(r[0] for r in rows)
    # the loss's own bf16 spread: the moved CPU runs' distance from the
    # reference CPU bf16 loss (weights x (1 +- 2^-22))
    moved_loss = [abs(step[f"moved{i}"][0] - cpu16) for i in (1, 2)]
    fmt = lambda rs: [(round(r[0], 3), r[1], f"diff {r[2]:.3g}",
                       f"noise {r[3]:.3g}", f"max {r[4]:.3g}", r[5])
                      for r in rs[:4]]
    log(f"  bf16 train step at batch {x.shape[0]}, dropout 0: loss card "
        f"{card:.6f} CPU bf16 {cpu16:.6f} CPU float32 {cpu32:.6f}; card "
        f"minus CPU bf16 on the trained and the two moved weights "
        f"{[f'{d:.3g}' for d in paired]}, mean {loss_diff:.3g} (bar "
        f"{loss_bar:.3g}: the larger of 1e-3 and half the CPU's "
        f"bf16-vs-float32 gap {gap:.3g}); two moved CPU bf16 runs "
        f"{moved_loss[0]:.3g}, {moved_loss[1]:.3g} from the CPU bf16 "
        f"loss; {len(rows)} "
        f"gradient tensors, each max |card - CPU bf16| over its bar (the "
        f"larger of {grad_parity.FLOOR:g} of its max |float32| and "
        f"{grad_parity.K:g} x its CPU bf16 noise): median {median:.3g}, "
        f"worst (ratio, tensor, ...) {fmt(rows)}; a moved CPU bf16 run "
        f"under the same rule: median "
        f"{statistics.median(r[0] for r in cpu_rows):.3g}, worst "
        f"{fmt(cpu_rows)}; one-element tensors over their own single gap, "
        f"unpooled: card up to {single['card'][0]:.3g} "
        f"({single['card'][1]}), a moved CPU run up to "
        f"{single['moved'][0]:.3g} ({single['moved'][1]}); the whole "
        f"gradient's L2 distance from the CPU's float32 {l2_ratio:.3g} x the "
        f"CPU bf16's (bar {BF16_GRAD_L2_BAR})")
    probed = {}
    if probe:
        loss_p, grads_p = step["card_plain_gconv"]
        rows_p = grad_parity.bf16_grad_parity(
            grads_p, c16, c32, [step["moved1"][1], step["moved2"][1]])
        probed = {"loss": loss_p, "loss_diff_cpu_bf16": abs(loss_p - cpu16),
                  "loss_diff_card": abs(loss_p - card),
                  "per_tensor_ratio_median": statistics.median(
                      r[0] for r in rows_p),
                  "per_tensor_worst": rows_p[:4],
                  "grad_l2_ratio": l2(grads_p) / l2(c16)}
        log(f"  probe, the same step on the card with the fused GatedConv's "
            f"plain bf16 versions in place of its kernels: loss "
            f"{loss_p:.6f}, {probed['loss_diff_cpu_bf16']:.3g} from the CPU "
            f"bf16 loss and {probed['loss_diff_card']:.3g} from the card's "
            f"with the kernels; gradient tensors over their bars: median "
            f"{probed['per_tensor_ratio_median']:.3g}, worst "
            f"{fmt(rows_p)}; L2 {probed['grad_l2_ratio']:.3g} x the CPU "
            f"bf16's")
    if not (finite and loss_diff <= loss_bar and rows[0][0] <= 1.0
            and l2_ratio <= BF16_GRAD_L2_BAR):
        raise AssertionError(f"bf16 train step card vs CPU: loss "
                             f"{loss_diff} (mean of {paired}) > {loss_bar}, "
                             f"worst "
                             f"gradient {fmt(rows)} or L2 {l2_ratio} > "
                             f"{BF16_GRAD_L2_BAR}")
    return {"loss_card": card, "loss_cpu_bf16": cpu16,
            "card_plain_gated_conv_probe": probed,
            "loss_cpu_float32": cpu32, "loss_bar": loss_bar,
            "loss_moved_cpu_bf16_diff": moved_loss,
            "loss_card_minus_cpu_bf16_by_draw": paired,
            "loss_card_minus_cpu_bf16_mean": loss_diff,
            "grad_bar_floor": grad_parity.FLOOR, "grad_bar_k": grad_parity.K,
            "grad_l2_ratio": l2_ratio, "per_tensor_ratio_median": median,
            "per_tensor_worst": rows[:4],
            "moved_cpu_ratio_median": statistics.median(
                r[0] for r in cpu_rows),
            "moved_cpu_worst": cpu_rows[:4],
            "one_element_over_own_gap": single}


def bf16_train_flagship(device, loader, seed, card, peak32):
    """Phase 20's flagship: phase 4's configuration, seeds and batches in a
    compute_dtype="bfloat16" model: ddi, 20 Adamax steps at dropout 0.2
    (every loss finite, the last 5 below the first, exact launch counts a
    step, no non-finite update), peak memory beside phase 4's float32;
    train images/s in turns with a float32 model on the same seeds and
    batches (windows of BF16_TRAIN_WINDOW_STEPS); one step card vs CPU at
    batch 2."""
    import dataclasses

    from gpnf_tpu_torch.models.marscf import MarScfConfig
    from gpnf_tpu_torch.ops import kernels

    cfg16 = MarScfConfig(**FLAGSHIP, compute_dtype="bfloat16")
    batches = [torch.from_numpy(b).to(device)
               for b, _ in zip(loader, range(16))]
    model, opt, one_step = _bf16_train_model(cfg16, device, batches, seed)
    base = _settled_memory(device)
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(TRAIN_STEPS)]  # gate: each read
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    log(f"  bf16: {TRAIN_STEPS} steps at batch {BATCH}, dropout {RATE}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} bits/dim; launches per step "
        f"{per_step}")
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  bf16 train peak device memory {peak / 2 ** 30:.3f} GiB, "
        f"{base / 2 ** 30:.3f} allocated before the steps (float32, phase 4: "
        f"{peak32 / 2 ** 30:.3f} GiB) [{card}]")
    want = {k: BF16_TRAIN.get(k, 0) for k in counts}
    if per_step != want:
        raise AssertionError(f"bf16 train launches per step {per_step} != "
                             f"{want}")
    if not (all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"bf16 train losses not finite and falling: "
                             f"{losses}")
    if opt.total_notfinite:
        raise AssertionError(f"{opt.total_notfinite} non-finite updates")

    # train images/s, float32 and bf16 in turns on the same seeds and batches
    _, _, step32 = _bf16_train_model(MarScfConfig(**FLAGSHIP), device,
                                     batches, seed)
    float(step32())  # the float32 model's first step, untimed
    times = {"float32": [], "bfloat16": []}
    for _ in range(BF16_TRAIN_WINDOWS):
        for name, fn in (("float32", step32), ("bfloat16", one_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BF16_TRAIN_WINDOW_STEPS):
                loss = fn()
            float(loss)  # each window ends in a loss read
            times[name].append(time.perf_counter() - t0)
    ips = {k: BF16_TRAIN_WINDOW_STEPS * BATCH / statistics.median(v)
           for k, v in times.items()}
    log(f"  train images/s in turns (median of {BF16_TRAIN_WINDOWS} windows "
        f"of {BF16_TRAIN_WINDOW_STEPS} steps at batch {BATCH}): float32 "
        f"{ips['float32']:.1f}, bf16 {ips['bfloat16']:.1f} ({times}) [{card}]")
    del step32
    torch.cuda.empty_cache()
    checks = bf16_card_vs_cpu_step(model, batches[1][:2].cpu(), device,
                                   FLAGSHIP, 20)
    return {"losses": losses, "launches": counts,
            "launches_per_step": per_step, "train_peak_memory_bytes": peak,
            "memory_before_steps_bytes": base,
            "float32_train_peak_memory_bytes": peak32,
            "train_images_per_s": ips, "train_window_s": times,
            "card_vs_cpu": checks}


def bf16_train_other_widths(device, seed, card):
    """Phase 20's other widths: one bf16 train step (dropout 0.2) of the
    flagship at C 192 (Dh 48, run 128 wide: the wide route at level 0) and
    of phase 18's --C 512 model (L 3, K 2, batch 16, the config the train
    CLI builds from --compute_dtype bfloat16), on random weights after
    ddi: the loss and every gradient finite, exact launch counts."""
    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.train_marscf import model_config, parse_args

    c512 = model_config(parse_args([*C512_ARGS, "--compute_dtype",
                                    "bfloat16"]), compute_dtype="bfloat16")
    n192 = sum(1 for s, _ in LEVELS if kernels.attention_route(
        s, 192, 4).entry == "proj") * 40
    out = {}
    for name, cfg, batch, want in (
            ("c192", MarScfConfig(**C192, compute_dtype="bfloat16"), BATCH,
             bf16_step_counts(120, n192, 12)),
            ("c512", c512, C512_BATCH, bf16_step_counts(C512_ATTN, 0, 6))):
        raw = get_dataset("synthetic", batch, seed=seed)[0].images[:batch]
        x = torch.from_numpy(next(iter(NumpyLoader(raw, batch, shuffle=False
                                                   )))).to(device)
        model = MarScfFlow(cfg, device=device, generator=torch.Generator(
            ).manual_seed(seed + 70))
        gen = torch.Generator(device=device).manual_seed(seed + 71)
        model.ddi(x, generator=gen)
        model.train()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(x, generator=gen)[1].mean()
        loss.backward()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        finite = math.isfinite(float(loss.detach())) and all(
            torch.isfinite(p.grad).all() for p in model.parameters()
            if p.grad is not None)
        want = {k: want.get(k, 0) for k in counts}
        log(f"  {name} in bf16: one train step at batch {batch}, loss "
            f"{float(loss.detach()):.4f} bits/dim, every gradient finite: {finite}, "
            f"{step_s:.3f} s with the first call's setup [{card}]; launches "
            f"{counts}")
        if counts != want or not finite:
            raise AssertionError(f"{name} bf16 train step: finite {finite}, "
                                 f"launches {counts} != {want}")
        out[name] = {"loss": float(loss.detach()), "launches": counts}
        del model
        torch.cuda.empty_cache()
    return out


# -- phase 21: training and serving the flagship in bf16 with the fused GatedConv --
# (batch, H, W, C) of the bf16 gated-conv kernels' checks: the flagship's
# 32-px levels and the 64-px level 0 (each timed), --C 512's 16x16 and 8x8
# at its batch, and C 12 (the narrow path: one value a copy), 48 and 160 at
# a small batch
FGC_BF16_CASES = ((BATCH, 16, 16, 96), (BATCH, 8, 8, 96), (BATCH, 4, 4, 96),
                  (BATCH, 32, 32, 96), (C512_BATCH, 16, 16, 512),
                  (C512_BATCH, 8, 8, 512), (4, 8, 8, 12), (4, 8, 8, 48),
                  (4, 4, 4, 160))
GCONV_RESULTS = ("out", "dx", "dw1", "db1", "dwg", "dbg")
FGC_BF16_STEPS = 10  # train steps of the bf16 fused flagship


def fgc_bf16(counts, fwd, bwd=None):
    """counts with `fwd` bf16 gated-conv forward calls and `bwd` backward
    calls (as many as forwards by default), on the entries' and the bf16
    kernels' counters."""
    bwd = fwd if bwd is None else bwd
    return {**counts, **dict.fromkeys(FGC[:1] + FGC_BF16[:1], fwd),
            **dict.fromkeys(FGC[1:] + FGC_BF16[1:], bwd)}


# a bf16 fused train step, eval batch and sampling pass: phase 20's and
# 19's with every GatedConv on the bf16 kernels
BF16_FGC_TRAIN = fgc_bf16(BF16_TRAIN, FGC_PER_PASS)
BF16_FGC_EVAL = fgc_bf16(BF16_EVAL, FGC_PER_PASS, 0)
BF16_FGC_SAMPLE = fgc_bf16(BF16_SAMPLE, FGC_PER_PASS, 0)


def check_gated_conv_bf16_kernels(device, timer, reports):
    """Phase 21's kernel checks: the bf16 forward and backward against the
    plain bf16 versions at FGC_BF16_CASES, rate 0 and 0.2 (one seed: the
    same mask), out and dx within one bf16 ulp of the largest |plain| plus
    their last product's float32 spread with at most 5% (out) and 10%
    (dx) of their values differing, the weight and bias gradients within GATED_CONV_WGRAD_BAR
    times the root sum of squares of their terms' bf16 rounding errors,
    element by element, and GATED_CONV_WGRAD_RMS times it in rms
    (`gated_conv_bf16_readings`); the plain versions with a rounding point
    moved or a split's pixels dropped (GATED_CONV_MOVED) each outside
    those bars; two calls of each bit for bit; the device launches of
    each call (a CUDA graph) against the source's plan; each C 96 case
    timed beside the plain version, the
    port's unfused bf16 chain (the GatedConv module + x on bf16: cuDNN
    convs and ATen; forward, forward + backward) and the float32 kernels on
    the same values, bound at the bf16 rate; bf16 HMMA in the SASS of every
    bf16 instantiation and their ptxas registers and spills."""
    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.ops.kernels import _native
    from gpnf_tpu_torch.ops.mixlogcdf import GatedConv
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    fgc = importlib.import_module(
        "gpnf_tpu_torch.ops.kernels.fused_gated_conv")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(2121)
    rows = {name: [] for name in FGC_BF16}
    for batch, h, w, c in FGC_BF16_CASES:
        module = GatedConv(c, generator=torch.Generator().manual_seed(
            c + h)).to(device)
        with torch.no_grad():
            w1 = module.conv.effective_weight(bf16).permute(
                2, 3, 1, 0).contiguous()
            wg = module.gate.effective_weight(bf16)[:, :, 0, 0].t(
                ).contiguous()
        b1, bg = (module.conv.b.detach().to(bf16),
                  module.gate.b.detach().to(bf16))
        x = torch.randn((batch, h, w, c), generator=gen,
                        device=device).to(bf16)
        g = torch.randn((batch, h, w, c), generator=gen,
                        device=device).to(bf16)
        args = (x, w1, b1, wg, bg)
        pixels = batch * h * w
        timed = c == FLAGSHIP["hidden_channels"]
        for rate in (0.0, RATE):
            seed = torch.tensor([2100 + h + c], dtype=torch.int32,
                                device=device)
            tag = f"bf16 gated conv (B, H, W, C) {(batch, h, w, c)} rate {rate}"
            fwd = lambda: kernels.fused_gated_conv(*args, rate, seed)
            bwd = lambda: kernels.fused_gated_conv_bwd(*args, g, rate, seed)
            with torch.no_grad():
                got = (fwd(), *bwd())
                again = (fwd(), *bwd())
                sound = fgc.gated_conv_bf16_readings(got, *args, g, rate,
                                                     seed)
                # the plain versions with a rounding point moved: each
                # must fall outside the bars
                moved = {m: fgc.gated_conv_bf16_readings(
                    got, *args, g, rate, seed, (m,))
                    for m in fgc.GATED_CONV_MOVED}
            errs = {n: sound[n]["max_abs"] for n in GCONV_RESULTS}
            over = {n: sound[n]["over_bar"] for n in GCONV_RESULTS}
            weights = GCONV_RESULTS[2:]
            unit = {k: {n: round(sound[n][k], 4) for n in weights}
                    for k in ("over_spread", "over_mass", "over_rss",
                              "rms_over_rss")}
            shares = {n: sound[n]["share"] for n in ("out", "dx")}
            caught = {m: not r["held"] for m, r in moved.items()}
            moved_rss = {m: round(max(r[n]["rms_over_rss"] for n in weights),
                                  3) for m, r in moved.items()}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            vec = c % 8 == 0
            plan = {part: fgc.gated_conv_plan(batch, h, w, c, rate > 0.0,
                                              part == "bwd", vec, bf16)[1]
                    for part in ("fwd", "bwd")}
            launches = {"fwd": graph_launches(fwd), "bwd": graph_launches(bwd)}
            log(f"  {tag}: max |kernel - plain| {errs}; over its bar (<= 1) "
                f"worst {max(over.values()):.3g}; values differing (<= "
                f"{fgc.GATED_CONV_BF16_SHARE}) {shares}; weight gradients' "
                f"worst |diff| over their sums' spread P 2^-24 sum|ab| "
                f"{unit['over_spread']}, over sum|ab| {unit['over_mass']}, "
                f"over 2^-8 (sum (ab)^2)^1/2 {unit['over_rss']} (bar "
                f"{fgc.GATED_CONV_WGRAD_BAR}), its rms {unit['rms_over_rss']}"
                f" (bar {fgc.GATED_CONV_WGRAD_RMS}); "
                f"plain versions with a moved rounding point caught: "
                f"{caught}, their worst weight gradient's rms over 2^-8 "
                f"(sum (ab)^2)^1/2 {moved_rss}; "
                f"two calls bit for bit: {same}; device launches "
                f"{launches} (plan {plan})")
            if not (sound["held"] and all(caught.values()) and same
                    and launches == plan):
                raise AssertionError(f"{tag}: {sound}, moved caught "
                                     f"{caught}, repeat {same}, launches "
                                     f"{launches} != {plan}")
            common = dict(shape=[batch, h, w, c], rate=rate, library_ms=None,
                          bar_ratio=over, differing_share=shares,
                          weight_readings=unit, moved_caught=caught,
                          moved_rms_over_rss=moved_rss, deterministic=same)
            times = {}
            if timed:
                args32, g32 = tuple(t_.float() for t_ in args), g.float()
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                g_nchw = g.permute(0, 3, 1, 2).contiguous()
                with torch.no_grad():
                    times = dict(
                        fwd=timer(fwd), bwd=timer(bwd),
                        plain_fwd=timer(lambda: kernels.gated_conv_plain(
                            *args, rate, seed)),
                        plain_bwd=timer(lambda: kernels.gated_conv_plain_bwd(
                            *args, g, rate, seed)),
                        f32_fwd=timer(lambda: kernels.fused_gated_conv(
                            *args32, rate, seed)),
                        f32_bwd=timer(lambda: kernels.fused_gated_conv_bwd(
                            *args32, g32, rate, seed)))
                module.drop_prob = rate
                module.train(rate > 0.0)  # the module's own Dropout2d
                chain = lambda xx: module(xx) + xx
                with torch.no_grad():
                    times["unfused_fwd"] = timer(lambda: chain(x_nchw))
                xr = x_nchw.clone().requires_grad_()
                params = list(module.parameters())
                times["unfused_fwd_bwd"] = timer(lambda: torch.autograd.grad(
                    chain(xr), [xr] + params, g_nchw))
                module.eval()
            notes = []
            for name, part in zip(FGC_BF16, ("fwd", "bwd")):
                bound_ms, bound_by = _bf16_bound(*fgc.gated_conv_work(
                    pixels, c, part == "bwd", bf16))
                row = dict(common, max_abs_err=max(
                    errs[n] for n in (("out",) if part == "fwd" else
                                      GCONV_RESULTS[1:])),
                    max_abs_err_by_result={n: errs[n] for n in (
                        ("out",) if part == "fwd" else GCONV_RESULTS[1:])},
                    bound_ms=bound_ms, bound_by=bound_by,
                    bound_peak="bf16 989 TFLOP/s",
                    device_launches=launches[part])
                if timed:
                    row.update(
                        ms=times[part], plain_ms=times[f"plain_{part}"],
                        float32_kernel_ms=times[f"f32_{part}"],
                        unfused_bf16_ms=times["unfused_fwd" if part == "fwd"
                                              else "unfused_fwd_bwd"])
                rows[name].append(row)
                notes.append(f"{bound_ms * 1e3:.2f} us ({bound_by})")
            if timed:
                log(f"  {tag}: kernel fwd {times['fwd']:.4f} bwd "
                    f"{times['bwd']:.4f} ms | plain bf16 fwd "
                    f"{times['plain_fwd']:.4f} bwd {times['plain_bwd']:.4f} "
                    f"ms | float32 kernels fwd {times['f32_fwd']:.4f} bwd "
                    f"{times['f32_bwd']:.4f} ms | unfused bf16 chain fwd "
                    f"{times['unfused_fwd']:.4f} fwd+bwd "
                    f"{times['unfused_fwd_bwd']:.4f} ms | bounds (bf16) "
                    f"{notes[0]} / {notes[1]}")
    hmma = {fn: row["hmma_ops"].get("HMMA.16816.F32.BF16", 0)
            for fn, row in sass_counts(_native.library_path(
                "fused_gated_conv")).items()
            if "gated_conv_mma_kernel" in fn and "OpBf16" in fn}
    ptxas = [r for r in ptxas_kernels(reports.get("fused_gated_conv", ""),
                                      "gated_conv_mma_kernel")
             if "OpBf16" in r["kernel"]]
    log(f"  gated_conv_mma_kernel<OpBf16, ...>: {len(hmma)} instantiations, "
        f"HMMA.16816.F32.BF16 a SASS: {sorted(hmma.values())}; ptxas "
        f"registers {sorted({r.get('registers') for r in ptxas})}, spill "
        f"stores {sorted({r.get('spill_stores') for r in ptxas})}")
    if not hmma or not all(hmma.values()):
        raise AssertionError(f"bf16 gated conv: no bf16 HMMA in {hmma}")
    return rows, {"sass_bf16_hmma": hmma, "ptxas": ptxas}


def bf16_fused_flagship(device, loader, test_loader, out_dir, seed, card,
                        peak20):
    """Phase 21's flagship: phase 4's configuration, seeds and batches with
    compute_dtype="bfloat16" and fused_gated_conv=True: ddi, FGC_BF16_STEPS
    Adamax steps at dropout 0.2 (every loss finite, the last 3 below the
    first, exact launch counts a step: every GatedConv on the bf16 kernels,
    none on the float32 ones, the attention as in phase 20), peak memory
    beside phase 20's; train images/s in turns with phase 20's unfused bf16
    step (windows of BF16_TRAIN_WINDOW_STEPS); one step card vs CPU at
    batch 2 (phase 20's bars), and the same step on the card through the
    plain versions of the gated conv (a probe, logged); one eval batch and
    one sampling pass, every image finite, with exact launch counts."""
    from gpnf_tpu_torch.data.datasets import NumpyLoader
    from gpnf_tpu_torch.models.marscf import MarScfConfig
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.training.loop import evaluate, save_sample_grid

    config = {**FLAGSHIP, "fused_gated_conv": True}
    batches = [torch.from_numpy(b).to(device)
               for b, _ in zip(loader, range(16))]
    model, opt, one_step = _bf16_train_model(
        MarScfConfig(**config, compute_dtype="bfloat16"), device, batches,
        seed)
    base = _settled_memory(device)
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(FGC_BF16_STEPS)]
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    per_step = {k: v / FGC_BF16_STEPS for k, v in counts.items()}
    want = {k: BF16_FGC_TRAIN.get(k, 0) for k in counts}
    log(f"  bf16 fused: {FGC_BF16_STEPS} steps at batch {BATCH}, dropout "
        f"{RATE}: losses {[round(v, 4) for v in losses]}; launches per step "
        f"{per_step}")
    log(f"  bf16 fused train peak device memory {peak / 2 ** 30:.3f} GiB, "
        f"{base / 2 ** 30:.3f} allocated before the steps (phase 20's "
        f"unfused bf16: {peak20 / 2 ** 30:.3f} GiB) [{card}]")
    if per_step != want:
        raise AssertionError(f"bf16 fused train launches per step {per_step}"
                             f" != {want}")
    if not (all(math.isfinite(v) for v in losses)
            and statistics.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"bf16 fused train losses not finite and "
                             f"falling: {losses}")
    if opt.total_notfinite:
        raise AssertionError(f"{opt.total_notfinite} non-finite updates")

    # train images/s, phase 20's unfused bf16 step and the fused one in turns
    _, _, unfused = _bf16_train_model(
        MarScfConfig(**FLAGSHIP, compute_dtype="bfloat16"), device, batches,
        seed)
    float(unfused())  # its first step, untimed
    times = {"unfused": [], "fused": []}
    for _ in range(BF16_TRAIN_WINDOWS):
        for name, fn in (("unfused", unfused), ("fused", one_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BF16_TRAIN_WINDOW_STEPS):
                loss = fn()
            float(loss)  # each window ends in a loss read
            times[name].append(time.perf_counter() - t0)
    ips = {k: BF16_TRAIN_WINDOW_STEPS * BATCH / statistics.median(v)
           for k, v in times.items()}
    log(f"  bf16 train images/s in turns (median of {BF16_TRAIN_WINDOWS} "
        f"windows of {BF16_TRAIN_WINDOW_STEPS} steps at batch {BATCH}): "
        f"unfused {ips['unfused']:.1f}, fused {ips['fused']:.1f} ({times}) "
        f"[{card}]")
    del unfused
    torch.cuda.empty_cache()
    checks = bf16_card_vs_cpu_step(model, batches[1][:2].cpu(), device,
                                   config, 21, probe_plain_gated_conv=True)

    model.eval()
    eval_loader = NumpyLoader(test_loader.images[:BATCH], BATCH,
                              shuffle=False)
    kernels.reset_launch_counts()
    nll = evaluate(model, eval_loader, generator=torch.Generator(
        device=device).manual_seed(seed + 80))
    eval_counts = kernels.launch_counts()
    want = {k: BF16_FGC_EVAL.get(k, 0) for k in eval_counts}
    log(f"  bf16 fused eval bits/dim {nll:.4f} over one batch of {BATCH}; "
        f"launches {eval_counts}")
    if eval_counts != want or not (math.isfinite(nll) and nll < 30.0):
        raise AssertionError(f"bf16 fused eval: {nll}, launches "
                             f"{eval_counts} != {want}")
    kernels.reset_launch_counts()
    path, nan_count = save_sample_grid(
        model, os.path.join(out_dir, "samples_bf16_fgc.png"), n=BATCH,
        generator=torch.Generator(device=device).manual_seed(seed + 81))
    sample_counts = kernels.launch_counts()
    want = {k: BF16_FGC_SAMPLE.get(k, 0) for k in sample_counts}
    log(f"  bf16 fused sampling pass: wrote {path}; {nan_count} NaN before "
        f"the clamp; launches {sample_counts}")
    if sample_counts != want or nan_count:
        raise AssertionError(f"bf16 fused sampling: {nan_count} NaN, "
                             f"launches {sample_counts} != {want}")
    return {"losses": losses, "launches": counts,
            "launches_per_step": per_step, "train_peak_memory_bytes": peak,
            "memory_before_steps_bytes": base,
            "unfused_bf16_train_peak_memory_bytes": peak20,
            "train_images_per_s": ips, "train_window_s": times,
            "card_vs_cpu": checks, "eval_bits_per_dim": nll,
            "eval_launches": eval_counts, "sample_launches": sample_counts}


def bf16_fused_other_models(device, seed, card):
    """Phase 21's other models: one bf16 fused train step (dropout 0.2) of
    the 64-px row (phase 14's configuration; level 0 the long entry at S
    1024) and of phase 18's --C 512 model (L 3, K 2, batch 16), on random
    weights after ddi: the loss and every gradient finite, exact launch
    counts."""
    import dataclasses

    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.train_marscf import model_config, parse_args

    c512 = dataclasses.replace(model_config(parse_args(
        [*C512_ARGS, "--compute_dtype", "bfloat16"]),
        compute_dtype="bfloat16"), fused_gated_conv=True)
    # 64 px: levels 1 and 2 on the proj entry (80 calls a pass), level 0 on
    # the long one, its projection a plain product, its attention the bf16
    # forward and backward kernels
    step64 = plus(bf16_step_counts(80, 80, 12), fused_attention_long=40,
                  fused_attention_long_bwd=40, attention_fwd_bf16=40,
                  attention_bwd_bf16=40)
    out = {}
    for name, cfg, batch, want in (
            ("imagenet64", MarScfConfig(**IMAGENET64, fused_gated_conv=True,
                                        compute_dtype="bfloat16"), BATCH,
             fgc_bf16(step64, FGC_PER_PASS)),
            ("c512", c512, C512_BATCH,
             fgc_bf16(bf16_step_counts(C512_ATTN, 0, 6), C512_ATTN))):
        raw = get_dataset("imagenet_64" if name == "imagenet64" else
                          "synthetic", batch, seed=seed)[0].images[:batch]
        x = torch.from_numpy(next(iter(NumpyLoader(raw, batch, shuffle=False
                                                   )))).to(device)
        model = MarScfFlow(cfg, device=device, generator=torch.Generator(
            ).manual_seed(seed + 90))
        gen = torch.Generator(device=device).manual_seed(seed + 91)
        model.ddi(x, generator=gen)
        model.train()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(x, generator=gen)[1].mean()
        loss.backward()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        finite = math.isfinite(float(loss.detach())) and all(
            torch.isfinite(p.grad).all() for p in model.parameters()
            if p.grad is not None)
        want = {k: want.get(k, 0) for k in counts}
        log(f"  {name} in bf16 with the flag: one train step at batch "
            f"{batch}, loss {float(loss.detach()):.4f} bits/dim, every "
            f"gradient finite: {finite}, {step_s:.3f} s with the first "
            f"call's setup [{card}]; launches {counts}")
        if counts != want or not finite:
            raise AssertionError(f"{name} bf16 fused train step: finite "
                                 f"{finite}, launches {counts} != {want}")
        out[name] = {"loss": float(loss.detach()), "launches": counts}
        del model
        torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                   help="where the sample grid and chip_smoke.json go")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also trace one train step, one eval batch and "
                        "one sampling pass at 32 and at 64 px, one joint "
                        "NLML + gradient at n = 1024 and 4096, one fused "
                        "train step at 32 px, and one train step and eval "
                        "batch of the CLIs' default C = 512")
    args = p.parse_args()
    t_start = time.perf_counter()
    phase_s, opened = {}, []  # each phase's seconds, header to header

    def phase(title=None):
        """Log a phase's header (None: the end), closing the phase before
        with its time."""
        now = time.perf_counter()
        if opened:
            number, since = opened.pop()
            phase_s[number] = now - since
            log(f"  phase {number} took {phase_s[number]:.1f} s")
        if title:
            opened.append((int(title.split(".")[0]), now))
            log(f"== {title}")

    phase("1. device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's paths need the card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in fp32, as the JAX package's (phase 19)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from gpnf_tpu_torch.utils.cuda_timing import Timer, card_line

    card = card_line()
    log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off (cuda.matmul and cudnn)")
    log(card)

    from gpnf_tpu_torch.data.datasets import NumpyLoader, get_dataset
    from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
    from gpnf_tpu_torch.ops import kernels
    from gpnf_tpu_torch.ops.kernels import _native

    phase("2. build")
    t0 = time.perf_counter()
    reports = _native.build()
    for name in _native.SOURCES:
        _native.load(name)
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(reports) or 'nothing (cached)'} in {build_s:.1f} s")
    for name, report in reports.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"  {name}: {regs[-1] if regs else report.strip()[-200:]}")
    os.makedirs(args.out, exist_ok=True)
    if reports:  # every kernel's registers, shared memory and spills
        with open(os.path.join(args.out, "ptxas.log"), "w") as f:
            f.write("".join(f"== {n}\n{r}" for n, r in reports.items()))
        log(f"  ptxas reports of every kernel in {args.out}/ptxas.log")

    model = MarScfFlow(MarScfConfig(**FLAGSHIP), device=device,
                       generator=torch.Generator().manual_seed(args.seed)).eval()
    train_loader, test_loader, _ = get_dataset("synthetic", BATCH,
                                               seed=args.seed)
    proto = next(iter(train_loader))
    model.ddi(torch.from_numpy(proto).to(device),
              generator=torch.Generator(device=device).manual_seed(args.seed))
    loader = NumpyLoader(test_loader.images[:4 * BATCH], BATCH, shuffle=False)

    phase("3. kernels vs plain versions (batch 64, the three levels)")
    timer = Timer(device)
    per_level = check_kernels(device, model, timer)

    phase(f"4. train: flagship, dropout {RATE}, batch {BATCH}")
    trained, train_step_fn = train(device, train_loader, args.out, args.seed,
                                   card)
    phase("5. serve: flagship eval bits/dim")
    nll, eval_counts = serve(model, loader, device, args.seed)
    phase("6. sample: ancestral grid")
    sample_counts, nan_count = sample(model, args.out, device, args.seed)
    phase("7. card vs CPU")
    checks = card_vs_cpu(model, proto, device)
    phase("8. timings")
    times = timings(model, loader, device, card)
    if args.profile:
        phase("9. profile: device time by kernel")
        times["profile"] = profile(flagship_runs(model, loader, device,
                                                 train_step_fn), device, card)
    del train_step_fn
    phase("10. GP kernels vs plain versions")
    gp_kernels, gp_backward = check_gp_kernels(device, timer)
    phase("11. flow -> GP: train_gp --flow at full size, tabular, card vs CPU")
    gp_out, gp_tab, gp_counts, gp_checks = gp_run(device, card)
    phase("12. GP timings")
    gp_times = gp_timings(device, card, gp_out, args.profile)
    # from phase 11's last count reset: its joint NLML + gradient, card vs
    # CPU and phase 12 take the default precision
    if kernels.cholesky_high.launches:
        raise AssertionError(f"phases 11-12 launched the Cholesky's \"high\" "
                             f"mode {kernels.cholesky_high.launches} times")

    model64 = MarScfFlow(MarScfConfig(**IMAGENET64), device=device,
                         generator=torch.Generator().manual_seed(args.seed + 40))
    attn64 = model64.levels[0].steps[0].coupling.net.blocks[0].attn
    phase("13. long attention kernels vs plain versions (64-px level 0)")
    with torch.no_grad():
        w64 = attn64.in_proj.effective_weight().contiguous()  # (288, 96)
    long_kernels = check_long_kernels(device, timer, w64, attn64.num_heads)
    phase(f"14. the ImageNet-64 row: train, eval, sample at batch {BATCH}")
    row64, x64 = imagenet64_row(model64, device, args.out, args.seed, card,
                                args.profile)
    phase("15. card vs CPU at 64 px")
    row64.update(encode_and_step_card_vs_cpu(model64, x64, device, IMAGENET64,
                                             9))
    state64 = model64.state_dict()
    del model64, attn64

    phase("16. fused GatedConv: kernels vs plain versions, the flagship with "
        "fused_gated_conv=True at 32 and 64 px")
    t0 = time.perf_counter()
    gconv = model.levels[0].steps[0].coupling.net.blocks[0].conv
    gconv_kernels = check_gated_conv_kernels(device, timer, gconv)
    log(f"  phase 16's kernel checks took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    fgc = fused_flagship(device, train_loader, loader, args.out, args.seed,
                         card, model, trained, nll, args.profile)
    torch.cuda.empty_cache()
    log(f"  phase 16's 32-px flagship took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    fgc64 = imagenet64_fused(device, state64, args.seed, card)
    del state64
    torch.cuda.empty_cache()
    log(f"  phase 16's 64-px row took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    fgc512 = c512_fused(device, args.seed, card)
    torch.cuda.empty_cache()
    log(f"  phase 16's C = 512 path took {time.perf_counter() - t1:.1f} s")
    phase("17. core attention kernels (fused_attention, fused_attention_qkv) "
        "vs plain versions")
    core_kernels, core_drive = check_core_attention(device, timer)
    phase("18. GatedAttn at every width: the tensor-core kernels (Dh = 128, "
        "256) vs plain versions, the flagship's routes, the CLIs' default "
        "--C 512 trained and served")
    lane_kernels = check_lane_kernels(device, timer)
    flagship_routes = flagship_routes_unchanged(device, model)
    c512 = cli_default_width(device, args.out, card)
    if args.profile:
        c512["profile"] = profile(c512_runs(device), device, card,
                                  keep=("gpnf::attention_lanes",
                                        "gpnf::attention_mma"))
    phase("19. serving the flagship in bf16: the bf16 qkv GEMM and "
        "attention forward vs plain versions, the flagship's eval and "
        "sampling, the 64-px row and --C 512")
    t0 = time.perf_counter()
    bf16_rows, bf16_build = check_bf16_kernels(device, timer, reports)
    log(f"  phase 19's kernel checks took {time.perf_counter() - t0:.1f} s")
    bf16 = bf16_flagship(device, model, loader, proto, nll, args.out,
                         args.seed, card)
    bf16.update(bf16_other_models(device, args.seed, card))
    check_aligned_route(19)
    phase("20. training the flagship in bf16: the bf16 dq and dK/dV pair "
        "and the bf16 GEMM's dseq and dW vs plain versions, every head "
        "width, the flagship's train steps, C 192 and --C 512")
    t0 = time.perf_counter()
    bf16_train_rows, bf16_train_build = check_bf16_train_kernels(
        device, timer, reports)
    log(f"  phase 20's kernel checks took {time.perf_counter() - t0:.1f} s")
    bf16_train = bf16_train_flagship(device, train_loader, args.seed, card,
                                     trained["train_peak_memory_bytes"])
    bf16_train.update(bf16_train_other_widths(device, args.seed, card))
    check_aligned_route(20)
    phase("21. the flagship in bf16 with the fused GatedConv: the bf16 "
        "gated-conv kernels vs plain versions, the flagship's train steps, "
        "eval and sampling, the 64-px row and --C 512")
    t0 = time.perf_counter()
    fgc16_rows, fgc16_build = check_gated_conv_bf16_kernels(device, timer,
                                                            reports)
    log(f"  phase 21's kernel checks took {time.perf_counter() - t0:.1f} s")
    fgc16 = bf16_fused_flagship(device, train_loader, test_loader, args.out,
                                args.seed, card,
                                bf16_train["train_peak_memory_bytes"])
    fgc16.update(bf16_fused_other_models(device, args.seed, card))
    unaligned = check_aligned_route(21)
    phase()

    attention = ("gpnf_tpu_torch/csrc/fused_attention_long.cu",
                 "gpnf_tpu/ops/pallas/fused_attention.py:")
    meta = {
        # the forward's work in two stages of the kernels below: the
        # projection (attention_gemm.cu), then the tensor-core forward
        # (through fused_attention_long.cu); the backward's in three: the
        # projection, dq and dK/dV, dseq and dW
        "fused_attention_proj": (attention[0], attention[1] + "393"),
        "fused_attention_proj_bwd": (attention[0], attention[1] + "416"),
        "mixlogcdf_forward": ("gpnf_tpu_torch/csrc/mixlogcdf_forward.cu",
                              "gpnf_tpu/ops/pallas/fused_mixlogcdf.py:33"),
        "mixture_inverse": ("gpnf_tpu_torch/csrc/mixture_inverse.cu",
                            "gpnf_tpu/ops/pallas/fused_mixture_inverse.py:70"),
        "fused_affine_forward": ("gpnf_tpu_torch/csrc/fused_affine.cu",
                                 "gpnf_tpu/ops/pallas/fused_coupling.py:22"),
        "cholesky": ("gpnf_tpu_torch/csrc/cholesky.cu",
                     "gpnf_tpu/ops/pallas/cholesky.py:220"),
        # trailing_precision="high": the same factorization, its trailing
        # launch with a bf16x3 branch (`_hbm_chol_kernel`'s :344 branch on
        # `_dot_bf16x3` :54)
        "cholesky_high": ("gpnf_tpu_torch/csrc/cholesky.cu",
                          "gpnf_tpu/ops/pallas/cholesky.py:291"),
        "tril_solve": ("gpnf_tpu_torch/csrc/tril_solve.cu",
                       "gpnf_tpu/ops/pallas/trisolve.py:84"),
        "fused_attention_long": (attention[0], attention[1] + "533"),
        "fused_attention_long_bwd": (attention[0], attention[1] + "554"),
        "fused_gated_conv": ("gpnf_tpu_torch/csrc/fused_gated_conv.cu",
                             "gpnf_tpu/ops/pallas/fused_gated_conv.py:139"),
        "fused_gated_conv_bwd": ("gpnf_tpu_torch/csrc/fused_gated_conv.cu",
                                 "gpnf_tpu/ops/pallas/fused_gated_conv.py:150"),
        "fused_attention": ("gpnf_tpu_torch/csrc/fused_attention.cu",
                            attention[1] + "43"),
        "fused_attention_bwd": ("gpnf_tpu_torch/csrc/fused_attention.cu",
                                attention[1] + "62"),
        "fused_attention_qkv": ("gpnf_tpu_torch/csrc/fused_attention.cu",
                                attention[1] + "230"),
        "fused_attention_qkv_bwd": ("gpnf_tpu_torch/csrc/fused_attention.cu",
                                    attention[1] + "257"),
        # the same four on bf16 operands (phase 17): the split forward on
        # TMA + wgmma, the split backward the 3xTF32 pair on widened bf16,
        # the packed pair the long entry's bf16 kernels
        "fused_attention_bf16": (
            "gpnf_tpu_torch/csrc/fused_attention_bf16.cu",
            attention[1] + "43"),
        "fused_attention_bwd_bf16": (
            "gpnf_tpu_torch/csrc/fused_attention_bf16.cu",
            attention[1] + "62"),
        "fused_attention_qkv_bf16": (
            "gpnf_tpu_torch/csrc/fused_attention_bf16.cu",
            attention[1] + "230"),
        "fused_attention_qkv_bwd_bf16": (
            "gpnf_tpu_torch/csrc/fused_attention_bf16.cu",
            attention[1] + "257"),
        # on phase 18's path (C = 512, S <= 512) the Dh = 128 kernels and
        # the GEMMs do together what the TPU's proj kernels do at that width
        "attention_lanes": ("gpnf_tpu_torch/csrc/attention_tiled.cuh",
                            attention[1] + "393"),
        # the tensor-core dq and dK/dV kernels, on mma_tf32.cuh
        "attention_lanes_bwd": ("gpnf_tpu_torch/csrc/attention_tiled.cuh",
                                attention[1] + "416"),
        "attention_qkv_gemm": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                               attention[1] + "393"),
        "attention_dseq_gemm": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                                attention[1] + "416"),
        "attention_dw_gemm": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                              attention[1] + "416"),
        # the bf16 serving path (phase 19): the proj forward's two stages
        # in bf16, the forward also the 64-px level 0's (`_fwd_kernel_bh`)
        "attention_qkv_gemm_bf16": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                                    attention[1] + "393"),
        "attention_fwd_bf16": ("gpnf_tpu_torch/csrc/attention_wgmma.cuh",
                               attention[1] + "393"),
        # the bf16 training path (phase 20): the proj backward's stages in
        # bf16, the dq and dK/dV pair also the long entry's (`_bwd_kernel_bh`)
        "attention_bwd_bf16": ("gpnf_tpu_torch/csrc/attention_tiled.cuh",
                               attention[1] + "416"),
        "attention_dseq_gemm_bf16": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                                     attention[1] + "416"),
        "attention_dw_gemm_bf16": ("gpnf_tpu_torch/csrc/attention_gemm.cu",
                                   attention[1] + "416"),
        # the bf16 fused GatedConv (phase 21): the same kernel template on
        # bf16 operands
        "fused_gated_conv_bf16": ("gpnf_tpu_torch/csrc/fused_gated_conv.cu",
                                  "gpnf_tpu/ops/pallas/fused_gated_conv.py:139"),
        "fused_gated_conv_bwd_bf16": (
            "gpnf_tpu_torch/csrc/fused_gated_conv.cu",
            "gpnf_tpu/ops/pallas/fused_gated_conv.py:150"),
    }
    # the headline shape of each GP kernel on the titular run (n = 1024):
    # the Cholesky in float32, the solve of the Cholesky VJP (p = n, L^T),
    # the affine coupling of level 0
    gp_headline = {"cholesky": ("n=1024", {"dtype": "float32"}),
                   "tril_solve": ("n=1024 p=1024", {"trans": True}),
                   "fused_affine_forward": ("(1024, 384)", {})}
    tiled = ["gpnf_tpu_torch/csrc/attention_tiled.cuh",
             "gpnf_tpu_torch/csrc/mma_tf32.cuh",
             "gpnf_tpu_torch/csrc/philox.cuh"]
    # the tensor-core forward at every width; the dq and dK/dV kernels
    mma_fwd = dict(device_kernels=["attention_mma_fwd_kernel"], headers=tiled)
    mma_bwd = dict(device_kernels=["attention_mma_dq_kernel",
                                   "attention_mma_dkv_kernel"], headers=tiled)
    record = []
    for kernel in kernels.KERNELS:
        name = kernel.__name__
        launches = {"train": trained["launches"][name],
                    "eval": eval_counts[name], "sample": sample_counts[name],
                    "gp": gp_counts[name],
                    "train64": row64["launches"][name],
                    "eval64": row64["eval_launches"][name],
                    "sample64": row64["sample_launches"][name],
                    "train_fgc": fgc["launches"][name],
                    "eval_fgc": fgc["eval_launches"][name],
                    "sample_fgc": fgc["sample_launches"][name],
                    "train64_fgc": fgc64["launches"][name],
                    "eval64_fgc": fgc64["eval_launches"][name],
                    "train_c512_fgc": fgc512["launches"][name],
                    "eval_c512_fgc": fgc512["eval_launches"][name],
                    "core_attention": core_drive[name],
                    "cholesky_high": gp_kernels["cholesky_high_drive"][name],
                    "train_c512": c512["launches"][name],
                    "serve_c512": c512["eval_launches"][name],
                    "eval_bf16": bf16["eval_launches"][name],
                    "sample_bf16": bf16["sample_launches"][name],
                    "eval64_bf16": bf16["imagenet64"]["eval_launches"][name],
                    "eval_c512_bf16": bf16["c512"]["eval_launches"][name],
                    "train_bf16": bf16_train["launches"][name],
                    "train_c192_bf16": bf16_train["c192"]["launches"][name],
                    "train_c512_bf16": bf16_train["c512"]["launches"][name],
                    "train_fgc_bf16": fgc16["launches"][name],
                    "eval_fgc_bf16": fgc16["eval_launches"][name],
                    "sample_fgc_bf16": fgc16["sample_launches"][name],
                    "train64_fgc_bf16": fgc16["imagenet64"]["launches"][name],
                    "train_c512_fgc_bf16": fgc16["c512"]["launches"][name]}
        entry = {"name": name, "route": "cuda", "source": meta[name][0],
                 "replaces": meta[name][1],
                 "launches": sum(launches.values()),
                 "launches_by_path": launches}
        if name in GP_KERNELS:
            rows = gp_kernels[name]
            shape, extra = gp_headline[name]
            top = [r for r in rows if r["shape"] == shape and all(
                r.get(k) == v for k, v in extra.items())][0]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=shape + "".join(f", {k} {v}" for k, v in extra.items()),
                backward_rel_err_vs_cpu_float64=gp_backward[name],
                per_shape=rows)
            if name == "cholesky":  # one CUDA factorization serves both
                entry["also_replaces"] = "gpnf_tpu/ops/pallas/cholesky.py:291"
                entry["device_launches_n1024"] = gp_kernels[
                    "cholesky_device_launches_n1024"]
            if name == "tril_solve":
                entry["device_launches"] = gp_kernels[
                    "tril_solve_device_launches"]
        elif name == "cholesky_high":
            # n = 4096 in float32, where the trailing products dominate;
            # "highest" on the same matrix and cholesky_ex beside it
            rows = gp_kernels[name]
            top = [r for r in rows if (r["shape"], r["dtype"]) ==
                   ("n=4096", "float32")][0]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"], highest_ms=top["highest_ms"],
                shape=f"n=4096, float32, panel width "
                      f"{top['panel_width']}; library_ms cholesky_ex",
                bound_peak="bf16x3 products at bf16 989 TFLOP/s (three "
                           "each), the rest at fp32 67 TFLOP/s",
                also_replaces="gpnf_tpu/ops/pallas/cholesky.py:344 "
                              "(`_dot_bf16x3` :54)",
                device_kernels=["chol_diag_kernel", "chol_panel_kernel",
                                "chol_trailing_kernel<T, true>"],
                headers=["gpnf_tpu_torch/csrc/mma_bf16.cuh",
                         "gpnf_tpu_torch/csrc/tile_mm.cuh"],
                device_launches_n1024=gp_kernels[
                    "cholesky_high_device_launches_n1024"],
                trailing_alone=gp_kernels["cholesky_high_trailing"],
                ptxas=ptxas_kernels(reports.get("cholesky", ""),
                                    "chol_trailing_kernel"),
                per_shape=rows)
        elif name in FGC_BF16:
            # the 32-px level 0 (16x16) at the training rate; the port's
            # unfused bf16 chain and the float32 kernels beside it, as no
            # library call computes the block
            rows = fgc16_rows[name]
            top = [r for r in rows if (tuple(r["shape"]), r["rate"]) ==
                   ((BATCH, 16, 16, FLAGSHIP["hidden_channels"]), RATE)][0]
            bwd = name == "fused_gated_conv_bwd_bf16"
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                bound_peak=top["bound_peak"], library_ms=None,
                unfused_bf16_ms=top["unfused_bf16_ms"],
                float32_kernel_ms=top["float32_kernel_ms"],
                device_launches_a_call=top["device_launches"],
                shape=f"32-px level 0 (16x16), batch {BATCH}, C 96, rate "
                      f"{RATE}; unfused_bf16_ms the GatedConv module + x on "
                      f"bf16, " + ("forward + backward" if bwd else
                                   "forward"),
                # bf16 mma.sync implicit GEMMs, mma_bf16.cuh
                device_kernels=["gated_conv_mma_kernel<OpBf16, ...>",
                                "sum_splits_kernel", "drop_scale_kernel"] + (
                    ["col_sums_kernel"] if bwd else []),
                headers=["gpnf_tpu_torch/csrc/mma_bf16.cuh",
                         "gpnf_tpu_torch/csrc/philox.cuh"],
                ptxas=fgc16_build["ptxas"],
                sass_bf16_hmma=fgc16_build["sass_bf16_hmma"],
                per_case=rows)
        elif name in FGC:
            # the 32-px level 0 (16x16) at the training rate; the unfused
            # chain's times beside it, as no library call computes the block
            rows = gconv_kernels[name]
            top = [r for r in rows if (r["shape"], r["c"], r["rate"]) ==
                   ("16x16", FLAGSHIP["hidden_channels"], RATE)][0]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                bound_fp32_ms=top["bound_fp32_ms"],
                library_ms=None, unfused_fwd_ms=top["unfused_fwd_ms"],
                unfused_fwd_bwd_ms=top["unfused_fwd_bwd_ms"],
                device_launches_a_call=top["device_launches"],
                shape=f"32-px level 0 (16x16), batch {BATCH}, C 96, rate "
                      f"{RATE}",
                # 3xTF32 mma.sync implicit GEMMs, mma_tf32.cuh
                device_kernels=["gated_conv_mma_kernel",
                                "sum_splits_kernel", "drop_scale_kernel"],
                headers=["gpnf_tpu_torch/csrc/mma_tf32.cuh",
                         "gpnf_tpu_torch/csrc/philox.cuh"],
                ptxas=[r for r in ptxas_kernels(
                    reports.get("fused_gated_conv", ""),
                    "gated_conv_mma_kernel") if "OpF32" in r["kernel"]],
                per_case=rows)
        elif name in BF16 and name not in bf16_rows:
            # phase 20's kernels at the flagship's level 0 (the backward at
            # rate 0, beside SDPA's autograd backward; dseq and dW beside
            # torch.matmul); every case, the 64-px level 0, C 512 and every
            # other width among them, in per_case
            rows = bf16_train_rows[name]
            top = rows[0]
            bwd = name == "attention_bwd_bf16"
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=f"level 0 (B, S, C) {tuple(top['shape'])}" + (
                    ", rate 0, dq scaled in float32 (the proj entry); "
                    "max_abs_err the largest of max |got - plain| / max "
                    "|plain| over dK, dV, dq; library_ms SDPA's autograd "
                    "backward on bf16" if bwd else
                    "; library_ms torch.matmul on bf16"),
                bound_peak="bf16 989 TFLOP/s", per_case=rows,
                device_kernels=(["attention_bf16_dq_kernel",
                                 "attention_bf16_dkv_kernel"] if bwd else
                                ["gemm_wgmma_bf16_kernel"]),
                headers=["gpnf_tpu_torch/csrc/philox.cuh",
                         "gpnf_tpu_torch/csrc/mma_bf16.cuh"] if bwd else
                ["gpnf_tpu_torch/csrc/wgmma_bf16.cuh"],
                ptxas=bf16_train_build["ptxas"][
                    name if bwd else "gemm_wgmma_bf16_kernel"])
            if bwd:
                entry.update(sass_bf16_hmma=bf16_train_build[
                                 "sass_bf16_hmma"]["attention_bf16_dq_kernel"],
                             sass_bf16_hmma_dkv=bf16_train_build[
                                 "sass_bf16_hmma"]["attention_bf16_dkv_kernel"])
            else:  # one device launch a call, no call on the unaligned route
                entry.update(sass_hgmma_tma=bf16_train_build[
                                 "sass_bf16_hmma"]["gemm_wgmma_bf16_kernel"],
                             device_launches_a_call=sorted(
                                 {r["device_launches"] for r in rows}),
                             unaligned_route_launches=unaligned)
        elif name in BF16:
            # the flagship's level 0 (the forward at rate 0, beside SDPA);
            # every case, the 64-px level 0 and C 512 among them, in per_case
            rows = bf16_rows[name]
            top = rows[0]
            gemm = name == "attention_qkv_gemm_bf16"
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=f"level 0 (B, S, C) {tuple(top['shape'])}" + (
                    "; library_ms torch.matmul on bf16" if gemm else
                    ", rate 0; library_ms SDPA on bf16"),
                bound_peak="bf16 989 TFLOP/s", per_case=rows,
                device_kernels=["gemm_wgmma_bf16_kernel" if gemm
                                else "attention_wgmma_fwd_kernel"],
                headers=["gpnf_tpu_torch/csrc/wgmma_bf16.cuh"] + ([] if gemm
                         else ["gpnf_tpu_torch/csrc/philox.cuh"]),
                ptxas=bf16_build["ptxas"][name],
                device_launches_a_call=sorted(
                    {r["device_launches"] for r in rows}))
            if gemm:  # none on the unaligned route
                entry.update(sass_hgmma_tma=bf16_build["sass_bf16_hmma"][
                                 "gemm_wgmma_bf16_kernel"],
                             unaligned_route_launches=unaligned)
            else:  # one exponential a score; every other width (phase 20)
                entry.update(sass_hgmma_tma=bf16_build["sass_bf16_hmma"][
                                 "attention_wgmma_fwd_kernel"],
                             exp_bound_ms=top["exp_bound_ms"],
                             per_width=bf16_train_rows[
                                 "attention_fwd_bf16_widths"])
        elif name in CORE_BF16:
            # the 32-px level 0's shape at rate 0 on bf16: kernel, plain
            # version, SDPA on bf16 and bound on the same inputs
            rows = core_kernels[name]
            top = [r for r in rows if (tuple(r["shape"]), r["rate"]) ==
                   (CORE_SHAPES[0], 0.0)][0]
            report = reports.get("fused_attention_bf16", "")
            ptxas = {
                "fused_attention_bf16": [
                    r for r in ptxas_kernels(report,
                                             "attention_wgmma_fwd_kernel")
                    if "SplitHeadsTma" in r["kernel"]],
                "fused_attention_bwd_bf16": [
                    r for r in ptxas_kernels(report, "attention_mma_d")],
                "fused_attention_qkv_bf16": [
                    r for r in ptxas_kernels(report,
                                             "attention_wgmma_fwd_kernel")
                    if "PackedQkv" in r["kernel"]],
                "fused_attention_qkv_bwd_bf16": ptxas_kernels(
                    report, "attention_bf16_d")}[name]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                bound_peak=top["bound_peak"],
                exp_bound_ms=top["exp_bound_ms"],
                library_ms=top["library_ms"],
                shape=f"(B, H, S, Dh) {CORE_SHAPES[0]}, bf16, rate 0; "
                      f"library_ms SDPA on bf16" + (
                          " (scale 1)" if "qkv" not in name else "") + (
                          ", its autograd backward" if "bwd" in name
                          else ""),
                device_kernels={
                    "fused_attention_bf16": [
                        "attention_wgmma_fwd_kernel<SplitHeadsTma<W>>"],
                    "fused_attention_bwd_bf16": [
                        "attention_mma_dq_kernel<SplitHeads<D>, bf16>",
                        "attention_mma_dkv_kernel<SplitHeads<D>, bf16>"],
                    "fused_attention_qkv_bf16": [
                        "attention_wgmma_fwd_kernel<PackedQkv<D>>"],
                    "fused_attention_qkv_bwd_bf16": [
                        "attention_bf16_dq_kernel",
                        "attention_bf16_dkv_kernel"]
                }[name],
                headers=(["gpnf_tpu_torch/csrc/attention_tiled.cuh",
                          "gpnf_tpu_torch/csrc/mma_tf32.cuh"]
                         if name == "fused_attention_bwd_bf16" else
                         ["gpnf_tpu_torch/csrc/attention_tiled.cuh",
                          "gpnf_tpu_torch/csrc/mma_bf16.cuh"]
                         if "bwd" in name else
                         ["gpnf_tpu_torch/csrc/attention_wgmma.cuh",
                          "gpnf_tpu_torch/csrc/wgmma_bf16.cuh"])
                + ["gpnf_tpu_torch/csrc/philox.cuh"],
                ptxas=ptxas, per_case=rows)
        elif name in CORE:
            # the 32-px level 0's shape at rate 0: kernel, plain version,
            # SDPA and bound on the same inputs (every case in per_case)
            rows = core_kernels[name]
            top = [r for r in rows if (tuple(r["shape"]), r["rate"]) ==
                   (CORE_SHAPES[0], 0.0)][0]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=f"(B, H, S, Dh) {CORE_SHAPES[0]}, rate 0; library_ms "
                      f"SDPA",
                per_case=rows)
            entry.update(
                bound_fp32_ms=top["bound_fp32_ms"],
                **(mma_bwd if name.endswith("_bwd") else mma_fwd),
                ptxas=ptxas_kernels(reports.get("fused_attention", ""),
                                    "attention_mma_d" if name.endswith("_bwd")
                                    else "attention_mma_fwd"))
        elif name in LANES or name in GEMMS:
            # the CLIs' width (C = 512, Dh = 128) at the 32-px level 0, batch
            # 16; the Dh = 128 / 256 kernels at rate 0, beside SDPA (every case,
            # rate 0.2 and Dh = 256 among them, in per_case)
            rows = lane_kernels[name]
            top = [r for r in rows if (r["c"], r["s"], r.get("rate", 0.0))
                   == (512, 256, 0.0)][0]
            # the GEMMs in the flagship's proj backward (C = 96): phase 3
            flagship = per_level.get(name, [])
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows + flagship),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=f"C 512 (4 heads of Dh 128), batch {C512_BATCH}, S 256"
                      + ("; library_ms torch.mm" if name in GEMMS else
                         ", rate 0; library_ms SDPA"),
                per_case=rows, **({"flagship_levels": flagship} if flagship
                                  else {}))
            if name in GEMMS:  # on the tensor cores, mma_tf32.cuh
                entry.update(
                    bound_fp32_ms=top["bound_fp32_ms"],
                    device_kernels=["gemm_mma_kernel", "sum_splits_kernel"],
                    headers=["gpnf_tpu_torch/csrc/mma_tf32.cuh"],
                    ptxas=ptxas_kernels(reports.get("attention_gemm", ""),
                                        "gemm_mma_kernel"))
            if name in LANES:  # on the tensor cores, mma_tf32.cuh
                fwd = name == "attention_lanes"
                entry.update(
                    bound_fp32_ms=top["bound_fp32_ms"],
                    **(mma_fwd if fwd else mma_bwd),
                    ptxas=ptxas_kernels(reports.get(
                        "fused_attention_long", ""),
                        "attention_mma_fwd" if fwd else "attention_mma_d"))
        elif name in long_kernels:
            # the 64-px level 0 at rate 0: kernel, plain version, SDPA and
            # bound on the same inputs (rate 0.2's rows in per_case)
            rows = long_kernels[name]
            top = [r for r in rows if (r["batch"], r["s"], r["rate"]) ==
                   (*LONG_CASES[0], 0.0)][0]
            # the backward's kernels in the flagship's proj backward: phase 3
            flagship = per_level.get(name, [])
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in rows + flagship
                                if r["max_abs_err"] is not None),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                shape=f"64-px level 0: batch {BATCH}, S 1024, rate 0; "
                      f"library_ms SDPA",
                per_case=rows, **({"flagship_levels": flagship} if flagship
                                  else {}))
            bwd = name == "fused_attention_long_bwd"
            entry.update(  # on the tensor cores, mma_tf32.cuh
                bound_fp32_ms=top["bound_fp32_ms"],
                **(mma_bwd if bwd else mma_fwd),
                ptxas=ptxas_kernels(reports.get("fused_attention_long", ""),
                                    "attention_mma_d" if bwd
                                    else "attention_mma_fwd"))
        else:
            # level 0 (the largest shape on the paths), at the training
            # rate; the library call (F.linear + SDPA, its backward) at rate 0
            rows = [r for r in per_level[name] if r["level"] == 0]
            top = [r for r in rows if r.get("rate", RATE) == RATE][0]
            entry.update(
                max_abs_err=max(r["max_abs_err"] for r in per_level[name]),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=rows[0]["library_ms"],
                shape=f"level 0, batch {BATCH}" + (
                    f", rate {RATE}; library_ms at rate 0 beside ms_rate_0"
                    if "rate" in top else ""),
                per_level=per_level[name])
            if "rate" in top:  # the kernel at the library call's rate
                entry["ms_rate_0"] = rows[0]["ms"]
            if "bound_fp32_ms" in top:
                entry["bound_fp32_ms"] = top["bound_fp32_ms"]
            if name in ("mixlogcdf_forward", "mixture_inverse"):
                # lane groups over K (mixture_lanes.cuh); ptxas of the
                # instantiation the paths' K = 32 runs
                group = kernels.fused_mixture_inverse.GROUP
                slots = -(-FLAGSHIP["num_components"] // group)
                entry.update(
                    headers=["gpnf_tpu_torch/csrc/mixture_lanes.cuh",
                             "gpnf_tpu_torch/csrc/mma_tf32.cuh"],
                    lane_group=group,
                    ptxas=ptxas_kernels(reports.get(name, ""),
                                        f"{name}_kernelILi{slots}E"))
            if name == "fused_attention_proj":
                entry["stages"] = [
                    "attention_qkv_gemm (gpnf_tpu_torch/csrc/attention_gemm.cu)",
                    "fused_attention_long: the tensor-core forward "
                    "attention_mma_fwd_kernel (gpnf_tpu_torch/csrc/"
                    "fused_attention_long.cu, attention_tiled.cuh)"]
                entry["stages_ms"] = top["stages_ms"]
            if name == "fused_attention_proj_bwd":
                entry["stages"] = [
                    "attention_qkv_gemm (gpnf_tpu_torch/csrc/attention_gemm.cu)",
                    "fused_attention_long_bwd: dq and dK/dV (gpnf_tpu_torch/"
                    "csrc/fused_attention_long.cu, attention_tiled.cuh)",
                    "attention_dseq_gemm (gpnf_tpu_torch/csrc/attention_gemm.cu)",
                    "attention_dw_gemm (gpnf_tpu_torch/csrc/attention_gemm.cu, "
                    "K split)"]
        record.append(entry)
    gp_summary = {
        "launches": gp_counts, "tabular": gp_tab, "card_vs_cpu": gp_checks,
        **gp_times,
        "pretrain_losses": gp_out["pretrain_losses"],
        **{m: {k: v for k, v in gp_out[m].items() if k != "model"}
           for m in ("raw", "frozen", "joint")}}
    summary = {"card": card, "build_s": build_s, "train": trained,
               "eval_bits_per_dim": nll, "nan_before_clamp": nan_count,
               **checks, **times, "gp": gp_summary, "imagenet64": row64,
               "fused_gated_conv": {"flagship": fgc, "imagenet64": fgc64,
                                    "c512": fgc512},
               "core_attention": {"drive_launches": core_drive,
                                  "agreement": core_kernels["agreement"],
                                  "beyond_2048": core_kernels["beyond_2048"]},
               "c512": {**c512, "wide_route": lane_kernels["wide_route"],
                        "flagship_routes": flagship_routes},
               "bf16": bf16, "bf16_train": bf16_train,
               "bf16_fused_gated_conv": fgc16, "phase_s": phase_s,
               "kernels": record}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"== phases 1-21 passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
