#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port (optimaltextures_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--profile]

Phases (each raises on failure; none catches its own):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (sm_90a), one nvcc per
     source, all started together, print ptxas's registers, shared memory
     and spills (and any "Performance Loss" remark), and check in the SASS
     (cuobjdump) that conv64's kernel and the bf16 conv3x3_p2's,
     conv3x3_full's and upconv_p2's (conv3x3_wg<64|128, ...> and
     upconv_wg<C>, csrc/conv_wg.cu) run HGMMA (wgmma) and no bf16 mma.sync
     conv kernel is left, the f32 kernels of conv3x3_p2, conv3x3_full and
     upconv_p2 HMMA on TF32, the f32 final_to_rgb's TMA loads (UTMALDG) and
     rgb_to_relu1's TMA stores (UTMASTG), their bf16 functions
     (final_to_rgb_mma and rgb_to_relu1_mma, csrc/edge_mma.cu) BF16 HMMA
     beside those and final_to_rgb_mma's ldmatrix (LDSM), and no bf16 FFMA
     edge kernel is left; no kernel of csrc/edge_mma.cu or csrc/conv_wg.cu
     may spill; the histogram's 128-bit loads and cluster barrier, and the
     128-bit loads and stores of the remap and of the legacy fused apply;
     each codec kernel's reflect and wrap instantiations are checked apart;
  3. every codec kernel at its 512-px main-path shapes, on inputs made by a
     512-px decode->encode roundtrip of the real depth-3 weights: held
     against its plain PyTorch version (|kernel - plain| <= 2e-5 *
     max|plain|: f32 sums of up to 1152 products in another order, three
     TF32 tensor-core products per product in conv3x3_p2, conv3x3_full and
     upconv_p2, whose signed mean error is printed so a rounding bias
     shows), and timed beside its plain version and one F.conv2d call (TF32
     off); the tensor-core kernels' bound is their 3xTF32 work at the TF32
     tensor-core rate (upconv_p2's on its folded 4 taps a fine pixel);
     then the two bytes-bound kernels, final_to_rgb and rgb_to_relu1, at
     512^2 and 256^2 (inputs from the same roundtrip at each size), each
     timed by the device's own record (torch.profiler's kernel time over
     R calls) beside the event-timed loop and the wrapper's host
     microseconds per call, with both bounds
     (optimaltextures_tpu_torch/tools/edge_convs.py);
  3b. the bf16 function of the five codec kernels (conv_dtype="bfloat16")
     at the same eight 512-px roundtrip shapes (inputs from a bf16 bank's
     roundtrip), at batch 1 and at batch 128 (128 distinct images, the
     relu1-scale tensors 2^31 elements), each against its bf16 plain
     version within 2^-7 x max|plain| (one bf16 rounding), with its signed
     mean error, repeated launches bit-equal, timed by the profiler's
     device time and by events beside its plain version, one cuDNN bf16
     F.conv2d and its bound (operations at the dense bf16 rate, bytes at
     the memory rate) (optimaltextures_tpu_torch/tools/bf16_codec.py);
  3w. the wrap mode (circular padding, tileable runs) of the ten codec
     kernel functions: the f32 five at the eight 512-px roundtrip shapes
     at batch 1 (2e-5 x max|plain| against the plain versions in wrap
     mode, the signed mean error printed), the bf16 five there at batch 1
     and 128 (2^-7 x max|plain|, repeated launches bit-equal), each timed
     by the profiler's device time beside its reflect instantiation on the
     same inputs; then every mode at 2 x 40 x 56 (every tile and strip an
     edge one, ragged) and 100 launches of final_to_rgb's wrap mode, f32
     and bf16, bit-equal to the first (its edge tiles' repair writes the
     image's far edge into a ring slot that TMA refills later);
  4. the three cdf kernels at the cdf step's shapes: the rotated relu1
     clouds of the 512-px pass at the C the PCA rule picks (k1), the rotated
     512x512 pixel clouds of the color tail (C = 3) and the rotated relu3
     clouds of the 256-px pass (k3 there, N = 64^2). The histogram of both
     clouds of a step (one launch) must equal its plain version and
     torch.histc exactly, the remap and the legacy fused apply (cdf_remap,
     on the plain histograms) equal their plain versions bit for bit; each
     timed by the device's own record (the profiler's kernel time over R
     calls, printed for each shape and summed) beside the event-timed loop, the
     wrapper's host microseconds a call, its plain version and, for the
     histogram, torch.histc called once per channel
     (optimaltextures_tpu_torch/tools/cdf_kernels.py); prints the k of
     every depth at every pass size and the bytes path A's cdf kernels
     must move in a run;
  4r. the cdf step's rotation products (rotate_rows with each row's range,
     unrotate_rows; csrc/rotgemm.cu, TF32 HGMMA in the SASS of phase 2) at
     the last pass's shapes of a batch-128 512-px cdf run (relu1, relu2,
     relu3 at the cell's traced PCA widths 25, 75, 177, and relu3 at 174,
     each tiling of the kernel's plan): each within 4x of torch.matmul's
     float32 error against a float64 product, the ranges equal to
     torch.aminmax of the rows, timed by the device's own record beside the
     event-timed loop, torch.matmul and the former expression
     (optimaltextures_tpu_torch/tools/rot_gemm.py); every run's launch
     counts include two rotate_rows and one unrotate_rows a cdf or sort step
     and a step of the opt color tail;
  5. the conv64 prototype kernel against its plain version at the tool's
     check shape (64 px, B = 128, the TMA path) and a ragged one (37 x 45,
     B = 5, the masked path), within
     2^-7 * max|plain| (one bf16 rounding), and again at the tool's
     512 px x 128, whose tensors pass 2^31 elements; there 100 repeated
     launches must equal the first bit for bit (a race in the kernel's ring
     shows so); timed there beside its plain version, its bound and one
     cuDNN bf16 F.conv2d + ReLU in channels-last;
  6. the paths, each once cold and once warm (lum once), every launch
     count set to 0 just before a run and checked just after it:
       main path: core.synthesize at 512 px, defaults otherwise (chol), the
         real depth-3 weights, a style exemplar made from --seed;
       path A: the same with hist_mode="cdf";
       path B: style transfer at 512 px, a content exemplar made from
         --seed, content_strength 0.2, chol, color_transfer "opt" (and
         "lum" once, with no cdf launch);
       path C: two-style texture mixing at 512 px, alpha 0.5, two exemplars
         made from --seed, chol (no cdf launch), then once warm with
         hist_mode="cdf", whose histogram and remap counts are path A's
         plus the mixing's own cross-matching;
     every cdf step launches the histogram once (both clouds) and the
     remap once;
  6b. the slice's path: the main path at batch 128 in bf16 (128 noise
     images, conv_dtype="bfloat16"), cold then warm: the walls, images/s,
     the peak device memory, the launches of every codec kernel (the bf16
     ones, one a call: the batch-1 path's counts; no f32 codec launch), the
     output (128, 512, 512, 3) finite, no two images equal, and its
     per-channel means beside the batch-1 f32 main path's; then a 64-px
     batch-8 bf16 run against the same run in f32 (same noise and injected
     rotations), held to 0.1523, JAX's own bf16-vs-f32 gap on the CPU
     parity test's inputs (tests/test_torch_batch.py);
  6c. the rest of the single-device Synthesizer at 512 px, launches
     counted as in phase 6: path D, out_width 768 (cold and warm, the pass
     plan printed, output (1, 512, 768, 3), the main path's f32 codec
     launches); path E, an init image (docs/samples/graffiti_sort_512.png)
     through api.run_files (the main path's launches); two runs of one
     Synthesizer with a styles_token (the second dispatches no style prep
     and equals the first within 1e-6), run(quantize_uint8=True) equal to
     the host formula on the float run, and low-memory prep
     (_PREP_PREFETCH_BYTES = 0) within 1e-6 of the normal run; path F,
     pca_bucket 16 then pca_traced_k (the widths beside the main path's;
     the traced run with transport.choose_k made to raise); path G,
     cov_propagation=False (wall and |G - main| beside the main path,
     channel means within 0.05); path H, batch 256 in bf16 in chunks of
     128, cold and warm (walls, images/s, peak memory, the bf16 codec
     launches twice the batch-1 path's, no f32 one, 256 distinct images),
     then one unchunked batch-256 run, whose peak memory must be higher;
  6d. tileable output at 512 px: path T, the main path's defaults with
     tileable=True (f32), cold, warm and one profiled run (walls, device
     busy), every wrap kernel launched the main path's count of its
     reflect mode and no reflect codec kernel; path T-bf16, the same at
     batch 8 in bf16 on kernels 1b-5b in wrap mode, then once with
     hist_mode="cdf" (path A's histogram and remap counts beside the wrap
     codec); each output's seam ratio (the mean |step| across the wrap
     seam over the interior neighbours', all of them and those at the
     seam's phase of the 32-px grid of shifts the run commutes with,
     seam_ratio) beside the main path's;
  6e. JAX tests/test_tileable.py's shift-equivariance on the kernels: 64
     px, depth 2, one pass of 6 iterations, the noise rolled by 16 px:
     |run(roll) - roll(run)| < 1e-2 tileable, in chol and cdf mode, the
     reflect run's error more than 10x that; 2 passes with multires (64 ->
     256 -> 64) < 2e-2;
  7. 64-px runs on the GPU against the same runs on the CPU (the kernels'
     plain versions), with the same inputs, injected rotations and mixing
     masks: the main path and chol mixing (max |gpu - cpu| <= 1e-3), cdf
     synthesis and cdf mixing (by distribution: cdf mode is chaotic at
     pass granularity) and transfer + opt (mean <= 3e-3, max <= 5e-2); and
     the main path at batch 2 in bf16 (max <= 0.1523, the bound of 6b);
     64 x 128 out_width, an init image, cov_propagation=False and batch 4
     in chunks of 2 in f32 (each max <= 1e-3); tileable, without and with
     multires (1e-3), at batch 2 in bf16 (0.1523) and in cdf mode (by
     distribution);
  8. the CLI on a style file from docs/samples/, and mixing two (needs
     Pillow);
  9. the HTTP server (optimaltextures_tpu_torch/serve.py, serve.serve(port=0):
     the GPU, one worker, coalesce 8) at 512 px with the main path's defaults,
     the style exemplar from --seed sent as a base64 PNG, every request's
     launches counted (set to 0 just before it): a cold seeded request, then
     8 warm ones (every body identical, the PNG byte-equal to a direct
     Synthesizer.run(..., quantize_uint8=True) of the same noise, the main
     path's f32 codec counts a request, no style prep: the styles_token
     cache); two unseeded requests (they differ); a cdf request (cold and
     warm: histogram and remap 246 launches each, path A's); jpeg and npy
     (equal to the png's pixels); a tileable request (200, the wrap
     kernels at the main path's counts, the image decoded); spatial_devices
     2 -> 400 "requested 2 devices, have 1" (one worker), the worker free
     afterwards; /healthz (the card's name)
     and /metrics (exactly the requests made); a second server with fresh
     pools importing the first one's style pack from OPTEX_PACK_DIR (its
     first seeded request: 0 style preps, the same bytes); on it two
     coalesced cohorts of 8 (the only worker checked out until the open
     cohort holds 8: X-Optex-Cohort 8, 8 distinct images, each f32 codec
     kernel launched the batch-1 counts); then the same twice on a third
     server with config_defaults conv_dtype bfloat16 (kernels 1b-5b at the
     batch-1 counts, no f32 codec launch). Prints the cold latency, the warm
     p50 and max, the first request after the restart, each cohort's wall
     and images/s beside 8 x the warm p50, and the cdf latencies, each with
     the card's name and power limit (needs Pillow);
  10. data parallelism (optimaltextures_tpu_torch/parallel/, ranks started
     by parallel.mesh.spawn, the rank bodies of
     optimaltextures_tpu_torch/tools/dryrun_multichip.py), 512 px, the main
     path's settings: two gloo ranks sharing this card (their walls are not
     DP scaling) run batch 2 in f32 cold and warm (each rank's launches the
     batch-1 main path's, the gathered output within 2e-3 of the batch-2
     run in one process: JAX's DP-vs-single bound), batch 2 in cdf mode
     (each rank's histogram and remap launches path A's, held by
     distribution), batch 256 in bf16, 128 a rank, cold and warm (each
     rank's bf16 launches the slice path's; held by distribution against
     the batch-256 run in one process, its mean |diff| within 1.5x that of
     the same run in chunks of 128: in bf16 another summation order of the
     Gram parts the runs pixel by pixel; walls, images/s, each rank's peak
     memory) and two
     styles style-parallel (within 2e-3 of both styles in one process);
     then one NCCL rank runs the main path (within 2e-3 of phase 6's
     output, its launches); with two or more cards, min(count, 4) NCCL
     ranks run batch N in f32 and 128 N in bf16 (launches as above),
     else a line says that this step was skipped;
  11. spatial sharding (parallel/spatial.py, parallel/grid.py; the rank
     bodies of tools/dryrun_multichip.py): two gloo ranks sharing this card
     split one 512-px image's rows (spatial_devices 2, the main path's
     settings, f32), every codec kernel run on the taller tensor of a
     shard and its neighbours' halo rows, then cropped: the main path cold
     and warm (within 2e-3 of phase 6's output; each rank's codec launches
     the main path's), tileable on the wrap ring (within 2e-3 of path T's
     output; path T's wrap launches) and cdf (by distribution against path
     A's output; path A's histogram and remap launches); four gloo ranks
     run the 2 x 2 grid at 128 px, batch 2 (within 2e-3 of the same run in
     one process); NCCL across cards with two or more, else a line says
     that this step was skipped. The phase prints its own clock;
  12. multi-device requests as the server serves them (serve.py on a
     persistent parallel.mesh.RankGroup): a gloo group of two ranks sharing
     this card, requests parsed by serve._parse_request (512 px, the main
     path's settings, the exemplar as a base64 PNG) run by
     serve._run_on_group: seeded spatial_devices 2 cold and 3 warm, then
     seeded num_devices 2 batch 2 cold and 3 warm, each bit-equal to one
     mesh.spawn of core.synthesize on the same decoded arrays and seed
     (both references in one spawn), each rank at the main path's
     launches, no style prep warm, the same rank pids throughout; two
     unseeded requests (they differ); a cdf spatial request (path A's
     histogram and remap launches a rank); close() ends every rank; with
     two or more cards an HTTP server with workers=2 (NCCL) within one
     uint8 level of the gloo output, else a line says that this step was
     skipped. The group's start, the cold and warm walls beside phases 10
     and 11's warm walls, and the phase's own clock are printed.

The last two lines of standard output are the {"kernels": [...]} line (all
nine kernels, each with its "design": ffma+tma, cluster-dsmem,
smem-tables, smem-segments, wgmma+tma or 3xtf32-mma; final_to_rgb and
rgb_to_relu1 also carry "device_ms", their profiler time at the 512^2
shape, and the three cdf kernels theirs summed over their three shapes,
with "device_ms_by_shape" (relu1, pixels, relu3) beside it; then the bf16
function of kernels 1-5, "<name>_bf16" with "dtype": "bfloat16", designs
wgmma-resident (conv3x3_p2_bf16, conv3x3_full_bf16 and upconv_p2_bf16,
csrc/conv_wg.cu) and mma+tma (final_to_rgb_bf16 and rgb_to_relu1_bf16,
csrc/edge_mma.cu), their times summed over the eight shapes at batch 128
and their launches those of the slice's path; then the wrap mode of the
ten, "<name>[_bf16]_wrap" with "pad": "wrap", their designs unchanged,
"device_ms" summed over the eight shapes (the bf16 ones at batch 128) with
"reflect_device_ms" beside it, their launches those of path T and path
T-bf16;
conv64 and cdf_remap are on no path of the program, so their launches are
those of their own check phase, which the "phase" field names; the rows
launched on phase 11's spatial runs also carry rank 0's launches there,
"spatial_launches", and the run, "spatial_phase") and
{"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no GPU is present or the package is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLE_STYLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")
SAMPLE_STYLE_B = os.path.join(REPO, "docs", "samples",
                              "zebra_pattern_lava_mix3_256.png")
INIT_IMAGE = os.path.join(REPO, "docs", "samples", "graffiti_sort_512.png")

# per kernel: its TPU original (file:line of the pallas_call wrapper)
REPLACES = {
    "rgb_to_relu1": "optimaltextures_tpu/ops/pallas/codec.py:578",
    "conv3x3_p2": "optimaltextures_tpu/ops/pallas/codec.py:282",
    "conv3x3_full": "optimaltextures_tpu/ops/pallas/codec.py:376",
    "upconv_p2": "optimaltextures_tpu/ops/pallas/codec.py:449",
    "final_to_rgb": "optimaltextures_tpu/ops/pallas/codec.py:515",
    "batched_histogram": "optimaltextures_tpu/ops/pallas/histogram.py:98",
    "pwl_remap": "optimaltextures_tpu/ops/pallas/pwl_remap.py:74",
    "cdf_remap": "optimaltextures_tpu/ops/pallas/cdf_remap.py:97",
    "conv64": "tools/pallas_conv_proto.py:109",
    # no Pallas kernel: the JAX package leaves the step's products to XLA
    "rotate_rows": "none (XLA at HIGHEST: optimaltextures_tpu/transport.py:125-126)",
    "unrotate_rows": "none (XLA at HIGHEST: optimaltextures_tpu/transport.py:134)",
}
REPLACES.update({k + "_bf16": REPLACES[k] for k in (
    "rgb_to_relu1", "conv3x3_p2", "conv3x3_full", "upconv_p2", "final_to_rgb")})
# the wrap mode (circular padding, tileable runs) of the ten codec kernel
# functions: no TPU kernel computes it (the JAX package leaves tileable runs
# to XLA's convs); each row names the Pallas kernel whose function it pads
# the other way
REPLACES.update({k + "_wrap": REPLACES[k] for k in list(REPLACES)
                 if k.split("_bf16")[0] in ("rgb_to_relu1", "conv3x3_p2",
                                            "conv3x3_full", "upconv_p2",
                                            "final_to_rgb")})
SOURCES = {"batched_histogram": "cdf", "pwl_remap": "cdf", "cdf_remap": "cdf",
           "conv64": "conv64", "conv3x3_p2_bf16": "conv_wg",
           "conv3x3_full_bf16": "conv_wg", "upconv_p2_bf16": "conv_wg",
           "final_to_rgb_bf16": "edge_mma", "rgb_to_relu1_bf16": "edge_mma",
           "rotate_rows": "rotgemm", "unrotate_rows": "rotgemm"}   # else codec
SOURCES.update({k + "_wrap": v for k, v in list(SOURCES.items()) if k.endswith("_bf16")})

# how each kernel computes: FFMA convs on the FP32 cores with their
# 64-channel side moved by TMA, wgmma fed by TMA, three TF32 mma.sync
# products (hi*hi + hi*lo + lo*hi), a thread-block cluster per histogram
# row reduced in distributed shared memory, the remap's segment tables
# built once per block in shared memory, cdf_remap's cdfs, remap and
# segment tables built once per block with each sample's segment guessed
# and verified; the bf16 wide convs run on
# wgmma with their weights resident in shared memory, the bf16 narrow ones
# on mma.sync with their weights in registers and their 64-channel side
# moved by TMA
TENSOR_CORE_CODEC = ("conv3x3_p2", "conv3x3_full", "upconv_p2")
EDGE_CODEC = ("final_to_rgb", "rgb_to_relu1")
_CODEC = TENSOR_CORE_CODEC + EDGE_CODEC
DESIGNS = {"conv64": "wgmma+tma", **{k: "3xtf32-mma" for k in TENSOR_CORE_CODEC},
           **{k: "ffma+tma" for k in EDGE_CODEC},
           **{k + "_bf16": "wgmma-resident" for k in TENSOR_CORE_CODEC},
           **{k + "_bf16": "mma+tma" for k in EDGE_CODEC},
           "batched_histogram": "cluster-dsmem", "pwl_remap": "smem-tables",
           "cdf_remap": "smem-segments", "rotate_rows": "3xtf32-wgmma-resident",
           "unrotate_rows": "3xtf32-wgmma-resident"}
DESIGNS.update({k + "_wrap": DESIGNS[k] for k in list(DESIGNS)
                if k.split("_bf16")[0] in _CODEC})
# JAX's own max|bf16 - f32| gap on tests/test_torch_batch.py's inputs (64
# px, batch 2, 2 passes, no PCA, injected rotations): the bound of every
# bf16 run held against another run here
BF16_RUN_GAP = 0.1523

# per redesigned kernel: its symbol in the SASS (a regex over the mangled
# name: conv3x3_tf32x3<CIN, COUT, ...>, upconv_tf32x3<C>, conv3x3_wg<COUT,
# CIN, ...>, upconv_wg<C>; "final_to_rgb_tmaE", the f32 FFMA kernel, not
# its bf16 instantiation "final_to_rgb_tmaI13__nv_bfloat16E" of earlier
# trees) and what the
# design relies on: each instruction with the operand type (or form) it
# must show (the cdf kernels' names as cuobjdump -sass prints them on the
# H100: 128-bit loads LDG.E.128.CONSTANT, stores STG.E.128, the cluster
# barrier UCGABAR_ARV / UCGABAR_WAIT)
# Each codec kernel's last template argument is its pad mode, WRAP (Lb0:
# reflect, Lb1: wrap); both instantiations must show the design.
_CODEC_SASS = (("conv3x3_p2", r"conv3x3_tf32x3ILi\d+ELi64ELb[01]ELb[01]ELb{}E",
                (("HMMA", "TF32"),)),
               ("conv3x3_full", r"conv3x3_tf32x3ILi\d+ELi128ELb[01]ELb[01]ELb{}E",
                (("HMMA", "TF32"),)),
               ("upconv_p2", r"upconv_tf32x3ILi\d+ELb{}E", (("HMMA", "TF32"),)),
               ("final_to_rgb", r"final_to_rgb_tmaILb{}E", (("UTMALDG", "UTMALDG"),)),
               ("rgb_to_relu1", r"rgb_to_relu1_tmaILb{}E", (("UTMASTG", "UTMASTG"),)),
               ("conv3x3_p2_bf16", r"conv3x3_wgILi64ELi\d+ELb[01]ELb[01]ELb{}E",
                (("HGMMA", "HGMMA"),)),
               ("conv3x3_full_bf16", r"conv3x3_wgILi128ELi\d+ELb[01]ELb[01]ELb{}E",
                (("HGMMA", "HGMMA"),)),
               ("upconv_p2_bf16", r"upconv_wgILi\d+ELb{}E", (("HGMMA", "HGMMA"),)),
               ("final_to_rgb_bf16", r"final_to_rgb_mmaILb{}E",
                (("HMMA", "BF16"), ("UTMALDG", "UTMALDG"), ("LDSM", "LDSM"))),
               ("rgb_to_relu1_bf16", r"rgb_to_relu1_mmaILb{}E",
                (("HMMA", "BF16"), ("UTMASTG", "UTMASTG"))))
SASS_CHECKS = (("conv64", r"conv64_wgmma", (("HGMMA", "HGMMA"),)),
               *((k, rx.format(0), needs) for k, rx, needs in _CODEC_SASS),
               *((k + "_wrap", rx.format(1), needs) for k, rx, needs in _CODEC_SASS),
               ("batched_histogram", r"histogram_cluster",
                (("LDG", "LDG.E.128"), ("UCGABAR", "UCGABAR_WAIT"))),
               ("pwl_remap", r"pwl_tables", (("LDG", "LDG.E.128"),
                                             ("STG", "STG.E.128"))),
               ("cdf_remap", r"cdf_segments", (("LDG", "LDG.E.128"),
                                               ("STG", "STG.E.128"))),
               ("rotate_rows", r"rot_gemm_fwd", (("HGMMA", "TF32"),)),
               ("unrotate_rows", r"rot_gemm_back", (("HGMMA", "TF32"),)))
# kernels a redesign replaced: no instantiation may be left in the libraries
SASS_GONE = (("conv3x3_full_bf16 on mma.sync", r"conv3x3_bf16ILi\d+ELi128E"),
             ("conv3x3_p2_bf16 on mma.sync", r"conv3x3_bf16ILi\d+ELi64E"),
             ("upconv_p2_bf16 on mma.sync", r"upconv_bf16"),
             ("final_to_rgb_bf16 on FFMA", r"final_to_rgb_tmaI13__nv_bfloat16E"),
             ("rgb_to_relu1_bf16 on FFMA", r"rgb_to_relu1_tmaI13__nv_bfloat16E"))
# the libraries none of whose kernels may spill (ptxas -v)
NO_SPILL = ("edge_mma", "conv_wg")


def _peaks(name: str, kind: str = "f32"):
    """(peak FLOP/s, HBM bytes/s) of the card: "f32" on the FP32 cores,
    "bf16" or "tf32" dense on the tensor cores (NVIDIA data sheets)."""
    from optimaltextures_tpu_torch.tools import edge_convs

    return edge_convs.peaks(name, kind)


def check_sass(libs) -> dict:
    """Disassemble the built libraries (cuobjdump beside nvcc) and count the
    instructions each redesigned kernel's design relies on (SASS_CHECKS:
    tensor-core, TMA, 128-bit memory and cluster-barrier instructions);
    raise unless each holds them."""
    from optimaltextures_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    funcs = {}
    for lib in libs:
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            funcs[part.split(None, 1)[0]] = part
    counts = {}
    for kernel, symbol, needs in SASS_CHECKS:
        bodies = [b for f, b in funcs.items() if re.search(symbol, f)]
        found = []
        for op, want in needs:
            lines = [l for b in bodies for l in b.splitlines() if op in l]
            n_op, n_want = len(lines), sum(want in l for l in lines)
            found.append(f"{n_op} {op} instructions, {n_want} of them {want}")
            if not bodies or n_want == 0:
                raise AssertionError(f"{kernel}: no {want} {op} in the SASS of "
                                     f"{symbol}")
            counts[(kernel, want)] = n_want
        print(f"sass {kernel}: {len(bodies)} kernel(s) {symbol}, "
              + "; ".join(found), flush=True)
    for what, symbol in SASS_GONE:
        left = [f for f in funcs if re.search(symbol, f)]
        if left:
            raise AssertionError(f"{what} is still built: {left}")
        print(f"sass {what}: none left ({symbol})", flush=True)
    return counts


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` calls of ``fn``, after a warm-up."""
    from optimaltextures_tpu_torch.tools import edge_convs

    return edge_convs.event_ms(fn, reps)


def _style_exemplar(seed: int, size: int = 512) -> np.ndarray:
    """A (1, size, size, 3) texture in [0, 1] from ``seed``."""
    from optimaltextures_tpu_torch.tools import edge_convs

    return edge_convs.style_exemplar(seed, size)


def _expected_launches(layer_depths, passes: int) -> dict:
    """Launches of each codec kernel in one run (models/fastcodec.py)."""
    per_pass = {"rgb_to_relu1": 0, "conv3x3_p2": 0, "conv3x3_full": 0,
                "upconv_p2": 0, "final_to_rgb": 0}
    for d in layer_depths:
        per_pass["rgb_to_relu1"] += 1
        per_pass["final_to_rgb"] += 1
        if d >= 2:
            per_pass["conv3x3_p2"] += 2                  # encoder + decoder
            per_pass["conv3x3_full"] += 1 if d == 2 else 2
            per_pass["upconv_p2"] += 1 if d == 2 else 2
    return {k: v * passes for k, v in per_pass.items()}


def check_kernels(seed: int, reps: int, card: str, pad: str = "reflect"):
    """Phase 3 (phase 3w with ``pad="wrap"``): every kernel at its 512-px
    main-path shapes vs its plain version in pad mode ``pad``, with times.
    Returns the per-kernel summary rows (``<name>_wrap`` in wrap mode, each
    shape also timed by the profiler's device time in both modes on the
    same inputs: ``device_ms`` and ``reflect_device_ms``)."""
    import torch
    import torch.nn.functional as F

    from optimaltextures_tpu_torch.models.vgg import VGGBank
    from optimaltextures_tpu_torch.ops import codec
    from optimaltextures_tpu_torch.tools import edge_convs

    dev = torch.device("cuda")
    peak_flops, peak_bw = _peaks(card)
    peak_tf32, _ = _peaks(card, "tf32")
    bank = VGGBank(3, device=dev)
    px = torch.as_tensor(_style_exemplar(seed), device=dev)

    # main-path inputs from one plain 512-px roundtrip (relu1/relu2 scales)
    t = edge_convs.roundtrip(bank, px)
    sc = t["stage"]
    enc_k, dec_k, plain = sc.head, sc.tail, codec.conv3x3_plain
    rgb, r11, r11p, r2a, d128, up128, d64, up64 = (
        t[k] for k in ("rgb", "r11", "r11p", "r2a", "d128", "up128", "d64", "up64"))

    wrap = pad == "wrap"

    def conv_call(x, p, up=False):
        t = x.permute(0, 3, 1, 2)
        if up:
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        t = F.pad(t, (1, 1, 1, 1), mode="circular" if wrap else "reflect").contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(t, p.w, p.b)

    # (kernel, label, wrapper, x, packed weights, wrapper kwargs, plain kwargs)
    relu, pool, up = dict(relu=True), dict(relu=True, pool=True), dict(relu=True, up=True)
    cases = [
        ("rgb_to_relu1", "3->64 relu, 512^2", codec.rgb_to_relu1, rgb,
         enc_k[0], {}, relu),
        ("conv3x3_p2", "enc 64->64 relu+pool, 512^2", codec.conv3x3_p2, r11,
         enc_k[1], pool, pool),
        ("conv3x3_p2", "dec 128->64 relu, 256^2", codec.conv3x3_p2, up128,
         dec_k[1], relu, relu),
        ("conv3x3_full", "enc 64->128 relu, 256^2", codec.conv3x3_full, r11p,
         enc_k[2], relu, relu),
        ("conv3x3_full", "enc 128->128 relu+pool, 256^2", codec.conv3x3_full,
         r2a, enc_k[3], pool, pool),
        ("upconv_p2", "dec up 128->128 relu, 128^2->256^2", codec.upconv_p2,
         d128, dec_k[0], {}, up),
        ("upconv_p2", "dec up 64->64 relu, 256^2->512^2", codec.upconv_p2,
         d64, dec_k[2], {}, up),
        ("final_to_rgb", "dec 64->3 + renorm, 512^2", codec.final_to_rgb,
         up64, sc.final, {}, {}),
    ]
    rows = {}
    for name, label, kern, x, p, kw, plain_kw in cases:
        kw, plain_kw = {**kw, "pad": pad}, {**plain_kw, "pad": pad}
        got = kern(x, p, **kw)
        ref = plain(x, p, **plain_kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= 2e-5 * max(scale, 1.0)):
            raise AssertionError(f"{name} [{label}, {pad}]: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        cout, cin = p.w.shape[:2]
        if name == "upconv_p2":
            # nearest-x2 then a 3x3 conv folds into 2x2 taps per output phase
            # (as the TPU kernel computes it): 4 taps per fine pixel, not 9
            taps, hc, wc = 4, 2 * x.shape[1], 2 * x.shape[2]
        else:
            taps, hc, wc = 9, x.shape[1], x.shape[2]
        flops = 2.0 * x.shape[0] * hc * wc * cout * cin * taps
        nbytes = 4.0 * (x.numel() + p.w.numel() + p.b.numel() + got.numel())
        t_flops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        if name in TENSOR_CORE_CODEC:
            # its least time is the 3xTF32 work on the tensor cores; the
            # FP32-core figure is printed beside it, and the signed mean
            # error: the tensor cores' accumulate rounds toward zero, so a
            # bias would show here before the cdf runs feel it
            t_fp32, t_flops = t_flops, 3 * flops / peak_tf32 * 1e3
            lean = float(((got - ref) * torch.sign(ref)).mean()) / scale
            print(f"kernel {name}{'_wrap' * wrap} {label}: bound on the FP32 cores "
                  f"{max(t_fp32, t_bytes):.4f} ms, 3xTF32 on the tensor cores "
                  f"{t_flops:.4f} ms; signed mean error {lean:.3e} of "
                  f"max|plain|", flush=True)
        ms = _time_ms(lambda: kern(x, p, **kw), reps)
        plain_ms = _time_ms(lambda: plain(x, p, **plain_kw), reps)
        lib_ms = _time_ms(conv_call(x, p, name == "upconv_p2"), reps)
        key = name + "_wrap" * wrap
        beside = ""
        if wrap:
            # the device's own record, this mode beside the reflect one
            dev = edge_convs.device_ms(lambda: kern(x, p, **kw), reps)
            dev_reflect = edge_convs.device_ms(
                lambda: kern(x, p, **{**kw, "pad": "reflect"}), reps)
            beside = f"  device {dev:.4f} ms (reflect {dev_reflect:.4f} ms)"
        print(f"kernel {key:18s} {label:36s} err {err:.2e} (max|plain| "
              f"{scale:.3e})  {ms:.4f} ms{beside}  plain {plain_ms:.4f} ms  "
              f"F.conv2d {lib_ms:.4f} ms  bound {max(t_flops, t_bytes):.4f} ms "
              f"({'operations' if t_flops >= t_bytes else 'bytes'})", flush=True)
        _add_row(rows, key, err, ms, plain_ms, lib_ms, t_flops, t_bytes)
        if wrap:
            for k, v in (("device_ms", dev), ("reflect_device_ms", dev_reflect)):
                rows[key][k] = rows[key].get(k, 0.0) + v
    if wrap:
        return rows

    # the two bytes-bound kernels at both ends of the pass sizes, by the
    # device's own record: the event-timed loop above can carry host time
    edge = edge_convs.time_edge_convs(seed, reps * 10, card)
    for name in EDGE_CODEC:
        rows[name]["device_ms"] = edge[(name, 512)]["device_ms"]
    return rows


def _add_row(rows, name, err, ms, plain_ms, lib_ms, t_flops, t_bytes):
    """Sum a kernel's per-shape numbers into its summary row (``lib_ms``
    None: no single library call computes the function)."""
    r = rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                   lib_ms=None if lib_ms is None else 0.0,
                                   bound=0.0, t_flops=0.0, t_bytes=0.0))
    r["err"] = max(r["err"], err)
    for k, v in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                 ("bound", max(t_flops, t_bytes)), ("t_flops", t_flops),
                 ("t_bytes", t_bytes)):
        if v is not None:
            r[k] += v


def check_bf16_kernels(seed: int, reps: int, card: str, pad: str = "reflect"):
    """Phase 3b (in phase 3w with ``pad="wrap"``): the bf16 function of
    every codec kernel at its eight 512-px roundtrip shapes, at batch 1 and
    128, vs its bf16 plain version in pad mode ``pad``, timed
    (tools/bf16_codec.py). Returns the per-kernel summary rows
    ("<name>_bf16", "<name>_bf16_wrap"): the error the larger of both
    batches', every time summed over the batch-128 shapes, the path's
    batch (a wrap row with the reflect mode's device time beside)."""
    from optimaltextures_tpu_torch.tools import bf16_codec

    timed = bf16_codec.check_and_time(seed, reps, card, (1, 128), pad=pad)
    rows, errs = {}, {}
    for (name, _, batch), r in timed.items():
        key = name + "_bf16" + "_wrap" * (pad == "wrap")
        errs[key] = max(errs.get(key, 0.0), r["err"])
        if batch != 128:
            continue
        _add_row(rows, key, r["err"], r["ms"], r["plain_ms"], r["lib_ms"],
                 r["t_flops"], r["t_bytes"])
        for k in ("device_ms", "reflect_device_ms"):
            if k in r:
                rows[key][k] = rows[key].get(k, 0.0) + r[k]
    for key, r in rows.items():
        r["err"] = errs[key]
        beside = (f" (reflect {r['reflect_device_ms']:.4f} ms)"
                  if "reflect_device_ms" in r else "")
        print(f"bf16 {key}: batch 128, eight shapes: device {r['device_ms']:.4f} ms"
              f"{beside}, events {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"cuDNN bf16 {r['lib_ms']:.4f} ms, bound {r['bound']:.4f} ms; max err "
              f"{r['err']:.3e} (batches 1 and 128)", flush=True)
    return rows


# every mode of the ten codec kernel functions on the stage roundtrip:
# (kernel, Cin, wrapper kwargs)
_WRAP_MODES = (("rgb_to_relu1", 3, {}), ("conv3x3_p2", 64, dict(relu=True, pool=True)),
               ("conv3x3_p2", 128, dict(relu=True)), ("conv3x3_full", 64, dict(relu=True)),
               ("conv3x3_full", 128, dict(relu=True, pool=True)), ("upconv_p2", 64, {}),
               ("upconv_p2", 128, {}), ("final_to_rgb", 64, {}))


def check_wrap_edges(seed: int):
    """Phase 3w, last part: every mode of the ten wrap functions at a size
    whose 16 x 16 tiles and strips all meet an edge and are ragged (2 x 40 x
    56; the upconv's coarse 20 x 28), random inputs, against the plain
    versions in wrap mode (2e-5 x max|plain| in f32, 2^-7 x max|plain| in
    bf16); then 100 launches of final_to_rgb's wrap mode, f32 and bf16, at 2
    x 40 x 56 x 64, bit-equal to the first (its repair writes the far edge
    into a ring slot that TMA refills later)."""
    import torch

    from optimaltextures_tpu_torch.ops import codec

    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    plain_kw = {"rgb_to_relu1": dict(relu=True), "upconv_p2": dict(relu=True, up=True)}

    def case(name, cin, dtype):
        cout = {"rgb_to_relu1": 64, "conv3x3_p2": 64, "conv3x3_full": 128,
                "upconv_p2": cin, "final_to_rgb": 3}[name]
        h, w = (20, 28) if name == "upconv_p2" else (40, 56)
        x = torch.rand((2, h, w, cin), generator=g, device="cuda")
        wt = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1
        b = torch.randn((cout,), generator=g, device="cuda") * 0.1
        if dtype == torch.bfloat16:
            x = x if name == "rgb_to_relu1" else x.to(dtype)
            wt, b = wt.to(dtype), b.to(dtype)
        return x, (codec.pack_up if name == "upconv_p2" else codec.pack)(wt, b)

    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for name, cin, kw in _WRAP_MODES:
            x, p = case(name, cin, dtype)
            got = getattr(codec, name)(x, p, pad="wrap", **kw)
            ref = codec.conv3x3_plain(x, p, pad="wrap", out_dtype=got.dtype,
                                      **{**kw, **plain_kw.get(name, {})})
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            bound = 2.0 ** -7 * scale if bf16 else 2e-5 * max(scale, 1.0)
            print(f"wrap edges {name}{'_bf16' * bf16}_wrap Cin {cin} "
                  f"{tuple(x.shape)}: err {err:.3e} (bound {bound:.3e})", flush=True)
            if not (torch.isfinite(got).all() and err <= bound):
                raise AssertionError(f"{name}{'_bf16' * bf16}_wrap at {tuple(x.shape)}: "
                                     f"max|kernel - plain| {err:.3e} > {bound:.3e}")
        x, p = case("final_to_rgb", 64, dtype)
        first = codec.final_to_rgb(x, p, pad="wrap")
        differ = sum(not torch.equal(codec.final_to_rgb(x, p, pad="wrap"), first)
                     for _ in range(100))
        print(f"wrap edges final_to_rgb{'_bf16' * bf16}_wrap at {tuple(x.shape)}: "
              f"{100 - differ} of 100 repeated launches bit-equal to the first",
              flush=True)
        if differ:
            raise AssertionError(f"final_to_rgb{'_bf16' * bf16}_wrap: {differ} of 100 "
                                 "repeated launches differ")


def check_cdf_kernels(seed: int, reps: int, card: str):
    """Phase 4: the three cdf kernels at the cdf step's shapes (relu1 of the
    512-px pass, the color tail's pixels, relu3 of the 256-px pass) vs
    their plain versions, timed by the profiler's device time beside the
    event-timed loop (tools/cdf_kernels.py); cdf_remap must equal its plain
    version bit for bit. Returns the per-kernel summary rows, summed over
    the three shapes, with each shape's device time apart; the cdf_remap
    row carries the launches of this phase."""
    from optimaltextures_tpu_torch.ops import cdf
    from optimaltextures_tpu_torch.tools import cdf_kernels

    cdf.reset_launches()
    timed, _, _ = cdf_kernels.time_cdf_kernels(seed, reps, card)
    rows = {}
    for (name, label), r in timed.items():
        if name == "cdf_remap" and not r["equal"]:
            raise AssertionError(f"cdf_remap [{label}]: not bit-equal to its plain "
                                 f"version (max diff {r['err']:.3e})")
        _add_row(rows, name, r["err"], r["ms"], r["plain_ms"], r["lib_ms"],
                 r["t_flops"], r["t_bytes"])
        rows[name]["device_ms"] = rows[name].get("device_ms", 0.0) + r["device_ms"]
        rows[name].setdefault("device_ms_by_shape", {})[label.split()[0]] = r["device_ms"]
    for name, r in rows.items():
        print(f"cdf {name} device ms by shape: "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["device_ms_by_shape"].items())
              + f"; summed {r['device_ms']:.4f}", flush=True)
    rows["cdf_remap"]["launches"] = cdf.LAUNCHES["cdf_remap"]
    return rows


def check_rot_gemm(reps: int, card: str):
    """Phase 4r: the cdf step's rotation products (rotate_rows, with each
    row's range, and unrotate_rows) at the last pass's shapes of a batch-128
    512-px cdf run against a float64 product and torch.matmul in float32
    (optimaltextures_tpu_torch/tools/rot_gemm.py: the ranges equal
    torch.aminmax of the rows, or it raises). Each kernel's relative RMS
    error may be at most 4x torch.matmul's at every shape of the tool's
    default: the cell's traced widths (relu1 25, relu2 75, relu3 177: odd,
    the staged back store, the 96-channel slices) and relu3 at 174. Returns
    the two rows summed over the cell's three shapes, each shape's device
    time apart."""
    from optimaltextures_tpu_torch.tools import rot_gemm

    timed = rot_gemm.time_rot_gemm(rot_gemm.SHAPES, reps, card)
    rows, by_shape = {}, {}
    for (name, label), r in timed.items():
        if r["rel_rms"] > 4 * r["lib_rel_rms"]:
            raise AssertionError(f"{name} [{label}]: relative RMS error "
                                 f"{r['rel_rms']:.3e} > 4 x torch.matmul's "
                                 f"{r['lib_rel_rms']:.3e}")
        by_shape.setdefault(name, {})[label.split(" N=")[0]] = r["device_ms"]
        if r["shape"] in rot_gemm.CELL_SHAPES:
            _add_row(rows, name, r["err"], r["ms"], r["plain_ms"], r["lib_ms"],
                     r["t_flops"], r["t_bytes"])
            rows[name]["device_ms"] = (rows[name].get("device_ms", 0.0)
                                       + r["device_ms"])
    for name, shapes in by_shape.items():
        rows[name]["device_ms_by_shape"] = shapes
    return rows


def check_conv64(reps: int, card: str):
    """Phase 5: the conv64 prototype kernel vs its plain version at the
    tool's check shape, a ragged one and the tool's 512 px x 128 (more than
    2^31 elements per tensor, so every 64-bit offset of the kernel is
    exercised); timed at 512 px x 128 beside its plain version, its bound
    and one cuDNN bf16 conv + ReLU (channels-last, the layout change made
    before the clock). Returns its row, with the launches of this phase."""
    import torch
    import torch.nn.functional as F

    from optimaltextures_tpu_torch.ops import conv64
    from optimaltextures_tpu_torch.tools import conv_proto

    def check(xpad, label):
        got = conv64.conv64(xpad, wrow)
        ref = conv64.conv64_plain(xpad, wrow)
        # compared in row bands: f32 copies of the whole 512-px pair would
        # take another 17 GB
        err = scale = 0.0
        finite = True
        for r0 in range(0, got.shape[0], 64):
            g, p = got[r0:r0 + 64].float(), ref[r0:r0 + 64].float()
            finite = finite and bool(torch.isfinite(g).all())
            err = max(err, float((g - p).abs().max()))
            scale = max(scale, float(p.abs().max()))
        if not (finite and err <= 2.0 ** -7 * scale):
            raise AssertionError(f"conv64 [{label}]: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        print(f"kernel conv64 {label}: err {err:.3e} (max|plain| {scale:.3e}, "
              f"bound 2^-7 x max|plain|)", flush=True)
        return err

    conv64.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (torch.randn((3, 3, 64, 64), generator=gen, device="cuda") * 0.1
         ).to(torch.bfloat16)
    wrow = conv64.pack_wrow(w)
    errs = []
    for h, wd, b in ((64, 64, 128), (37, 45, 5)):
        xpad = torch.randn((h + 2, wd + 2, 64, b), generator=gen,
                           device="cuda").to(torch.bfloat16)
        errs.append(check(xpad, f"{h}x{wd} B={b}"))
    del xpad

    size, b = 512, 128
    xpad = torch.randn((size + 2, size + 2, 64, b), generator=gen,
                       device="cuda").to(torch.bfloat16)
    errs.append(check(xpad, f"{size}x{size} B={b}"))
    torch.cuda.empty_cache()
    # the kernel sums each output in a fixed order, so repeated launches
    # agree bit for bit; a race in its producer/consumer ring shows as a
    # launch that does not (7-10 of 100 at this shape before the consumers
    # released only columns they had seen land)
    first = conv64.conv64(xpad, wrow)
    differ = sum(not torch.equal(conv64.conv64(xpad, wrow), first)
                 for _ in range(100))
    print(f"kernel conv64 {size}x{size} B={b}: {differ} of 100 repeated "
          f"launches differ from the first", flush=True)
    if differ:
        raise AssertionError(f"conv64: {differ} of 100 repeated launches "
                             "differ from the first")
    del first
    ms = _time_ms(lambda: conv64.conv64(xpad, wrow), reps)
    plain_ms = _time_ms(lambda: conv64.conv64_plain(xpad, wrow), reps)
    torch.cuda.empty_cache()
    xcl = xpad.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    del xpad
    wcl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_ms = _time_ms(lambda: torch.relu_(F.conv2d(xcl, wcl)), reps)
    del xcl
    flops, nbytes = conv_proto.work(size, b)
    peak_flops, peak_bw = _peaks(card, "bf16")
    t_flops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    print(f"kernel conv64 {size}x{size} B={b}: {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TF/s)  plain {plain_ms:.4f} ms  cuDNN bf16 "
          f"conv+ReLU {lib_ms:.4f} ms  bound {max(t_flops, t_bytes):.4f} ms "
          f"({'operations' if t_flops >= t_bytes else 'bytes'})", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    row = {}
    _add_row(row, "conv64", max(errs), ms, plain_ms, lib_ms, t_flops, t_bytes)
    row["conv64"]["launches"] = conv64.LAUNCHES["conv64"]
    return row


def _counts():
    from optimaltextures_tpu_torch.ops import cdf, codec, conv64, rotgemm

    return {**codec.LAUNCHES, **cdf.LAUNCHES, **conv64.LAUNCHES,
            **rotgemm.LAUNCHES}


def _reset_counts():
    from optimaltextures_tpu_torch.ops import cdf, codec, conv64, rotgemm

    codec.reset_launches()
    cdf.reset_launches()
    conv64.reset_launches()
    rotgemm.reset_launches()


def mixing_matches(cfg) -> int:
    """The hist_match calls of one run's mixing: every pass cross-matches
    each ordered pair of its N styles (N (N - 1)) at every depth."""
    from optimaltextures_tpu_torch.utils import schedule

    n = len(cfg.style)
    table, _ = schedule.iters_and_sizes(cfg.size, cfg.iters, cfg.passes,
                                        not cfg.no_multires, num_layers=3)
    return n * (n - 1) * len(table[0]) * len(table) if n > 1 else 0


def expected_counts(cfg) -> dict:
    """Every kernel's launches in one run of ``cfg``: the codec's per stage
    roundtrip (its bf16 kernels' in a bf16 run, whatever the batch, their
    wrap mode's in a tileable run; the other dtype's and the other pad
    mode's none), one histogram launch (both clouds) and one remap
    per cdf step (each sliced-OT iteration of hist_mode "cdf", each step of
    the opt color tail, and each cross-matching of cdf-mode mixing), two
    rotate_rows (pastiche and style) and one unrotate_rows per rotated step
    (each iteration of "cdf" or "sort", each step of the opt color tail;
    the mixing's cross-matching rotates nothing); cdf_remap and conv64 are
    on no path."""
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.utils import schedule

    depths = [3 - l for l in range(3)]
    table, _ = schedule.iters_and_sizes(cfg.size, cfg.iters, cfg.passes,
                                        not cfg.no_multires, num_layers=3)
    steps = rotated = 0
    if cfg.hist_mode in ("cdf", "sort"):
        rotated = sum(map(sum, table))
    if cfg.hist_mode == "cdf":
        steps = rotated + mixing_matches(cfg)
    if cfg.color_transfer == "opt":
        steps += core.COLOR_STEPS
        rotated += core.COLOR_STEPS
    # a batch_chunk run launches every codec kernel once per chunk
    chunks = (cfg.batch // cfg.batch_chunk
              if cfg.batch_chunk and cfg.batch > cfg.batch_chunk else 1)
    codec_counts = {k: v * chunks for k, v in
                    _expected_launches(depths, cfg.passes).items()}
    suffix = ("_bf16" if cfg.conv_dtype == "bfloat16" else "") + (
        "_wrap" if cfg.tileable else "")
    return {**{k + dt + pd: 0 for k in codec_counts for dt in ("", "_bf16")
               for pd in ("", "_wrap")},
            **{k + suffix: v for k, v in codec_counts.items()},
            "batched_histogram": steps, "pwl_remap": steps,
            "cdf_remap": 0, "conv64": 0,
            "rotate_rows": 2 * rotated, "unrotate_rows": rotated}


def drive_path(name: str, cfg, styles, content=None, labels=("cold", "warm"),
               run=None):
    """Run ``cfg`` through core.synthesize (or ``run()``, which returns the
    output and its seconds) once per label, each run's launch counts set to
    0 just before it and checked just after. Returns the last run's counts,
    the walls, the last output (numpy) and the peak device memory of each
    run."""
    import torch

    from optimaltextures_tpu_torch import core

    expected = expected_counts(cfg)
    launches, walls, peaks = None, [], []
    shape = ((1, cfg.size, cfg.size, 3) if content is not None else
             (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3))
    if run is None:
        run = lambda: core.synthesize(cfg, styles, content, device="cuda")
    for label in labels:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        out, seconds = run()
        launches = _counts()
        peaks.append(torch.cuda.max_memory_allocated())
        o = out if isinstance(out, np.ndarray) else out.cpu().numpy()
        del out
        walls.append(seconds)
        print(f"{name} ({label}): {seconds:.4f} s, peak {peaks[-1] / 2**30:.2f} "
              f"GiB, output {o.shape}, range [{o.min():.4f}, {o.max():.4f}], "
              f"launches {launches}", flush=True)
        if o.shape != shape or not np.isfinite(o).all():
            raise AssertionError(f"{name}: output {o.shape} is not finite {shape}")
        if o.min() < -1.5 or o.max() > 2.5 or o.std() < 1e-3:
            raise AssertionError(f"{name}: output out of a sane range")
        if launches != expected:
            raise AssertionError(f"{name}: launch counts {launches} != "
                                 f"expected {expected}")
        torch.cuda.synchronize()
    return launches, walls, o, peaks


def paths(seed: int, profile: bool):
    """Phase 6: the main path, path A (cdf), path B (transfer + opt, then
    lum) and path C (two-style mixing, then in cdf mode). Returns the launch
    counts of the main path and of path A, the main path's output and
    walls, and path A's output."""
    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1)
    content = _style_exemplar(seed + 3)
    pair = [style, _style_exemplar(seed + 5)]
    main_cfg = OptexConfig(size=512, seed=seed, style=["smoke_style"])
    cdf_cfg = OptexConfig(size=512, seed=seed, hist_mode="cdf",
                          style=["smoke_style"])
    opt_cfg = OptexConfig(size=512, seed=seed, content="smoke_content",
                          content_strength=0.2, color_transfer="opt",
                          style=["smoke_style"])
    lum_cfg = OptexConfig(size=512, seed=seed, content="smoke_content",
                          content_strength=0.2, color_transfer="lum",
                          style=["smoke_style"])
    # the README's mixing command: --style a b --mixing_alpha 0.5
    mix_cfg = OptexConfig(size=512, seed=seed, mixing_alpha=0.5,
                          style=["smoke_style", "smoke_style_b"])
    mix_cdf_cfg = OptexConfig(size=512, seed=seed, mixing_alpha=0.5,
                              hist_mode="cdf",
                              style=["smoke_style", "smoke_style_b"])
    main_counts, main_walls, main_out, _ = drive_path("main path", main_cfg,
                                                      [style])
    cdf_counts, _, cdf_out, _ = drive_path("path A, cdf synthesis", cdf_cfg,
                                           [style])
    drive_path("path B, transfer + opt", opt_cfg, [style], content)
    drive_path("path B, transfer + lum", lum_cfg, [style], content, ("warm",))
    mix_counts, *_ = drive_path("path C, mixing", mix_cfg, pair)
    if mix_counts != main_counts:
        raise AssertionError(f"path C: launches {mix_counts} != the main "
                             f"path's {main_counts}")
    mix_cdf_counts, *_ = drive_path("path C, cdf mixing", mix_cdf_cfg, pair,
                                    labels=("warm",))
    own = mixing_matches(mix_cdf_cfg)
    for name in ("batched_histogram", "pwl_remap"):
        if mix_cdf_counts[name] != cdf_counts[name] + own:
            raise AssertionError(
                f"path C (cdf): {name} {mix_cdf_counts[name]} != path A's "
                f"{cdf_counts[name]} + the mixing's {own}")
    print(f"path C (cdf): the mixing's own cross-matching: {own} hist_match "
          f"calls, {own} histogram launches (both clouds each) and {own} "
          f"remaps on top of path A's", flush=True)
    if profile:
        for name, cfg, sty, cont in (("main", main_cfg, [style], None),
                                     ("cdf", cdf_cfg, [style], None),
                                     ("transfer_opt", opt_cfg, [style], content),
                                     ("mix", mix_cfg, pair, None)):
            profile_run(name, cfg, sty, cont)
    return main_counts, cdf_counts, main_out, main_walls, cdf_out


def slice_path(seed: int, main_counts, main_out, profile: bool):
    """Phase 6b: the main path at batch 128 in bf16, cold then warm; its
    launches must be the batch-1 f32 path's, on the bf16 kernels. Returns
    the warm run's counts."""
    import torch

    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1)
    batch = 128
    cfg = OptexConfig(size=512, seed=seed, batch=batch, conv_dtype="bfloat16",
                      style=["smoke_style"])
    counts, walls, out, peaks = drive_path("slice path, batch 128 bf16", cfg,
                                           [style])
    want = {k + "_bf16": v for k, v in main_counts.items() if k in _CODEC}
    if ({k: counts[k] for k in want} != want
            or any(counts[k] for k in _CODEC)):
        raise AssertionError(f"slice path: launches {counts} are not the batch-1 "
                             f"path's {main_counts} on the bf16 kernels")
    distinct = len({image.tobytes() for image in out})
    if distinct != batch:
        raise AssertionError(f"slice path: only {distinct} of {batch} images "
                             "differ")
    means, ref = out.reshape(-1, 3).mean(0), main_out.reshape(-1, 3).mean(0)
    print(f"slice path, batch {batch} bf16: walls cold {walls[0]:.4f} s, warm "
          f"{walls[1]:.4f} s; {batch / walls[0]:.1f} and {batch / walls[1]:.1f} images/s; "
          f"peak device memory {peaks[0] / 2**30:.2f} / {peaks[1] / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); launches {want} (the batch-1 "
          f"path's, one a call); output {out.shape}, finite, no two images "
          f"equal; per-channel means {np.round(means, 4).tolist()} vs the "
          f"batch-1 f32 main path's {np.round(ref, 4).tolist()}", flush=True)
    if float(np.abs(means - ref).max()) > 0.05:
        raise AssertionError(f"slice path: channel means {means} far from the "
                             f"batch-1 path's {ref}")
    del out
    if profile:
        profile_run("batch128_bf16", cfg, [style])
    torch.cuda.empty_cache()
    return counts


def bf16_vs_f32_batch8():
    """Phase 6b, second part: 64 px, batch 8, bf16 vs f32 on the same noise
    and injected rotations (the CPU parity test's settings; its first two
    images are that test's inputs), held to BF16_RUN_GAP."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.utils import imageio

    style = imageio.load_image(SAMPLE_STYLE, 64)
    noise = np.random.default_rng(5).uniform(size=(8, 64, 64, 3)).astype(np.float32)
    rotations = _rotation_stream(17)
    outs = {}
    for dt in ("float32", "bfloat16"):
        _reset_counts()
        cfg = OptexConfig(size=64, passes=2, iters=60, no_multires=True, depth=3,
                          seed=0, no_pca=True, batch=8, conv_dtype=dt,
                          style=["graffiti.png"])
        outs[dt] = core.Synthesizer(cfg, device="cuda").run(
            noise, [style], rotations=rotations).cpu().numpy()
        suffix = "_bf16" if dt == "bfloat16" else ""
        if not all(_counts()[k + suffix] for k in _CODEC):
            raise AssertionError(f"batch-8 {dt}: a codec kernel did not launch: "
                                 f"{_counts()}")
    gap = np.abs(outs["bfloat16"] - outs["float32"]).reshape(8, -1).max(1)
    print(f"64-px batch 8, bf16 vs f32 on the GPU: max abs diff per image "
          f"{np.round(gap, 4).tolist()} (bound {BF16_RUN_GAP})", flush=True)
    if not (np.isfinite(outs["bfloat16"]).all() and gap.max() <= BF16_RUN_GAP):
        raise AssertionError(f"batch-8 bf16 vs f32 gap {gap.max()} > {BF16_RUN_GAP}")
    torch.cuda.synchronize()


def _kept_run(synth, cfg, styles, **run_kw):
    """core.synthesize's steps on a kept Synthesizer (the same noise from the
    same run key), so that its state (last_run_ks, the styles_token cache)
    can be read after the run. Returns (output, seconds)."""
    import torch

    from optimaltextures_tpu_torch import core

    run_key = synth.next_run_key()
    noise = core.draw_noise(synth.device, run_key,
                            (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3))
    t0 = time.time()
    out = synth.run(noise, styles, key=run_key, **run_kw)
    torch.cuda.synchronize()
    return out, time.time() - t0


def _codec_part(counts, suffix=""):
    return {k + suffix: counts[k + suffix] for k in _CODEC}


def settings_paths(seed: int, main_counts, main_out, main_walls,
                   profile: bool = False):
    """Phase 6c: the settings of the rest of the single-device Synthesizer
    at 512 px with the real depth-3 weights: paths D (out_width 768), E
    (init through api.run_files), F (pca_bucket 16, then pca_traced_k), G
    (cov_propagation=False) and H (batch 256 bf16 in chunks of 128, beside
    one unchunked batch-256 run), then the styles_token, quantize_uint8 and
    low-memory prep runs. Each run's launches are counted as drive_path
    counts them."""
    import torch

    from optimaltextures_tpu_torch import api, core, transport
    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1)
    base = dict(size=512, seed=seed, style=["smoke_style"])
    main_cfg = OptexConfig(**base)
    main_codec = _codec_part(main_counts)

    # path D: non-square synthesis
    cfg = OptexConfig(out_width=768, **base)
    plan = core.Synthesizer(cfg, device="cuda")._plan_passes((512, 768))
    print(f"path D, out_width 768: pass plan {plan}", flush=True)
    counts, walls, out_d, peaks = drive_path("path D, out_width 768", cfg, [style])
    if _codec_part(counts) != main_codec:
        raise AssertionError(f"path D: codec launches {counts} != the main "
                             f"path's {main_codec}")
    print(f"path D: walls cold {walls[0]:.4f} s, warm {walls[1]:.4f} s; peak "
          f"{peaks[1] / 2**30:.2f} GiB; output {out_d.shape}, range "
          f"[{out_d.min():.4f}, {out_d.max():.4f}]; codec launches the main "
          f"path's", flush=True)

    # path E: an init image through the file API
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_init_",
                               dir=os.path.join(REPO, "build"))
    cfg = OptexConfig(size=512, seed=seed, style=[SAMPLE_STYLE], init=INIT_IMAGE,
                      output_dir=out_dir)
    counts, walls, out_e, _ = drive_path(
        "path E, init", cfg, None, labels=("warm",),
        run=lambda: api.run_files(cfg, device="cuda")[:2])
    if _codec_part(counts) != main_codec:
        raise AssertionError(f"path E: codec launches {counts} != the main "
                             f"path's {main_codec}")
    print(f"path E, init {os.path.basename(INIT_IMAGE)}: {walls[0]:.4f} s, "
          f"output {out_e.shape}, wrote {os.listdir(out_dir)}", flush=True)

    # the styles_token runs: two runs of one Synthesizer, the second with no
    # style prep; then quantize_uint8 on the same Synthesizer
    synth = core.Synthesizer(main_cfg, device="cuda")
    inner, preps = synth._dispatch_style_prep, [0]

    def counted_prep(*args):
        preps[0] += 1
        return inner(*args)

    synth._dispatch_style_prep = counted_prep
    token_outs, token_preps = [], []
    for label in ("first", "second"):
        n0 = preps[0]
        _, walls, o, _ = drive_path(
            "tokened", main_cfg, [style], labels=(label,),
            run=lambda: _kept_run(synth, main_cfg, [style],
                                  styles_token="smoke_style"))
        token_outs.append(o)
        token_preps.append(preps[0] - n0)
    tok_err = float(np.abs(token_outs[1] - token_outs[0]).max())
    print(f"tokened: style preps dispatched {token_preps[0]} then "
          f"{token_preps[1]}; max |second - first| {tok_err:.3e}", flush=True)
    if token_preps[0] == 0 or token_preps[1] != 0 or tok_err > 1e-6:
        raise AssertionError(f"tokened: preps {token_preps}, diff {tok_err}")
    main_ks = synth.last_run_ks
    _reset_counts()
    q, _ = _kept_run(synth, main_cfg, [style], quantize_uint8=True)
    if _counts() != expected_counts(main_cfg):
        raise AssertionError(f"quantize run: launches {_counts()}")
    q = q.cpu().numpy()
    host = (np.clip(token_outs[0], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    mismatch = int((q != host).sum())
    print(f"quantize_uint8: dtype {q.dtype}, shape {q.shape}, {mismatch} bytes "
          f"differ from the host formula on the float run", flush=True)
    if q.dtype != np.uint8 or mismatch:
        raise AssertionError(f"quantize_uint8: {mismatch} bytes differ")

    # low-memory prep: every pass's prep dispatched in phase C
    low = core.Synthesizer(main_cfg, device="cuda")
    low._PREP_PREFETCH_BYTES = 0
    counts, walls, out_low, _ = drive_path(
        "low-memory prep", main_cfg, [style], labels=("warm",),
        run=lambda: _kept_run(low, main_cfg, [style]))
    low_err = float(np.abs(out_low - token_outs[0]).max())
    print(f"low-memory prep: {walls[0]:.4f} s; max |low - normal| "
          f"{low_err:.3e}", flush=True)
    if low_err > 1e-6:
        raise AssertionError(f"low-memory prep differs by {low_err}")

    # path F: bucketed, then traced k
    ks = {}
    for name, kw in (("pca_bucket 16", dict(pca_bucket=16)),
                     ("pca_traced_k", dict(pca_traced_k=True))):
        cfg = OptexConfig(**kw, **base)
        synth = core.Synthesizer(cfg, device="cuda")
        choose_k = transport.choose_k
        if "traced" in name:
            def no_host_decision(_):
                raise AssertionError("pca_traced_k took a host k-decision")
            transport.choose_k = no_host_decision
        try:
            counts, walls, out_f, _ = drive_path(
                f"path F, {name}", cfg, [style], labels=("warm",),
                run=lambda: _kept_run(synth, cfg, [style]))
        finally:
            transport.choose_k = choose_k
        ks[name] = synth.last_run_ks
        print(f"path F, {name}: {walls[0]:.4f} s; widths {synth.last_run_ks} "
              f"beside the main path's {main_ks}; max |F - main| "
              f"{float(np.abs(out_f - main_out).max()):.3e}", flush=True)
    for (bk, exact) in zip(ks["pca_bucket 16"], main_ks):
        for w, k, c in zip(bk, exact, (256, 128, 64)):
            if not (w >= k and (w % 16 == 0 or w == c)):
                raise AssertionError(f"pca_bucket 16 widths {bk} vs {exact}")
    if any(tuple(w) != (256, 128, 64) for w in ks["pca_traced_k"]):
        raise AssertionError(f"pca_traced_k widths {ks['pca_traced_k']}")

    # path G: the per-iteration moment loop, same seed (same rotations)
    cfg = OptexConfig(cov_propagation=False, **base)
    counts, walls, out_g, _ = drive_path("path G, cov_propagation=False", cfg,
                                         [style], labels=("warm",))
    diff = np.abs(out_g - main_out)
    means, ref = out_g.reshape(-1, 3).mean(0), main_out.reshape(-1, 3).mean(0)
    print(f"path G: wall {walls[0]:.4f} s beside the main path's warm "
          f"{main_walls[-1]:.4f} s; |G - main| max {float(diff.max()):.3e}, "
          f"mean {float(diff.mean()):.3e}; per-channel means "
          f"{np.round(means, 4).tolist()} vs {np.round(ref, 4).tolist()}",
          flush=True)
    if float(np.abs(means - ref).max()) > 0.05:
        raise AssertionError(f"path G: channel means {means} vs {ref}")

    # path H: batch 256 bf16 in chunks of 128, beside one unchunked run
    batch = 256
    cfg = OptexConfig(batch=batch, batch_chunk=128, conv_dtype="bfloat16",
                      **base)
    counts, walls, out_h, peaks = drive_path(
        "path H, batch 256 bf16, batch_chunk 128", cfg, [style])
    want = {k + "_bf16": 2 * v for k, v in main_codec.items()}
    if _codec_part(counts, "_bf16") != want or any(counts[k] for k in _CODEC):
        raise AssertionError(f"path H: launches {counts} are not twice the "
                             f"batch-1 path's on the bf16 kernels")
    distinct = len({image.tobytes() for image in out_h})
    if distinct != batch:
        raise AssertionError(f"path H: only {distinct} of {batch} images differ")
    del out_h
    torch.cuda.empty_cache()
    whole_cfg = OptexConfig(batch=batch, conv_dtype="bfloat16", **base)
    _, whole_walls, out_w, whole_peaks = drive_path(
        "path H, batch 256 bf16 unchunked", whole_cfg, [style], labels=("warm",))
    del out_w
    torch.cuda.empty_cache()
    print(f"path H, batch {batch} bf16, batch_chunk 128: walls cold "
          f"{walls[0]:.4f} s, warm {walls[1]:.4f} s; {batch / walls[0]:.1f} and "
          f"{batch / walls[1]:.1f} images/s; peak device memory "
          f"{peaks[0] / 2**30:.2f} / {peaks[1] / 2**30:.2f} GiB; unchunked "
          f"warm {whole_walls[0]:.4f} s ({batch / whole_walls[0]:.1f} images/s), "
          f"peak {whole_peaks[0] / 2**30:.2f} GiB; bf16 launches {want} (twice "
          f"the batch-1 path's), no f32 codec launch; {distinct} distinct "
          f"images", flush=True)
    if not max(peaks) < whole_peaks[0]:
        raise AssertionError(f"path H: chunked peak {max(peaks)} not below the "
                             f"unchunked {whole_peaks[0]}")
    if profile:
        for name, kw in (("out_width768", dict(out_width=768)),
                         ("no_cov_prop", dict(cov_propagation=False)),
                         ("traced_k", dict(pca_traced_k=True)),
                         ("batch256_chunk128_bf16",
                          dict(batch=batch, batch_chunk=128,
                               conv_dtype="bfloat16"))):
            profile_run(name, OptexConfig(**kw, **base), [style],
                        shapes="out_width" in kw)
        torch.cuda.empty_cache()


def shift_period(cfg) -> int:
    """The least shift (output pixels) a tileable run of ``cfg`` commutes
    with: at every pass size it must be a whole multiple of the pooling
    stride 2^(depth-1) (32 for the 512-px default schedule, whose passes are
    256, 320, 384, 448 and 512 px)."""
    from optimaltextures_tpu_torch.utils import schedule

    _, sizes = schedule.iters_and_sizes(cfg.size, cfg.iters, cfg.passes,
                                        not cfg.no_multires, num_layers=3)
    stride = 2 ** (cfg.depth or 3) // 2
    return next(s for s in range(1, cfg.size + 1)
                if all(s * n % cfg.size == 0 and s * n // cfg.size % stride == 0
                       for n in sizes))


def seam_ratio(out, period: int = 32):
    """How visible an output's wrap seam is: the mean |step| across it (the
    last column to the first, the last row to the first) over (a) the mean
    |step| between all interior neighbours and (b) that between interior
    neighbours at the seam's phase of the grid of shifts the run commutes
    with (columns P k - 1 and P k, rows the same, P = ``period``,
    shift_period: a step across a pool window's edge is larger than one
    inside it, and the seam lies on such an edge at every scale). (b) is
    about 1 for an output that tiles; both are larger where the tiles would
    meet at a seam."""
    o = np.asarray(out, np.float64)
    p = period
    seam = (np.abs(o[:, :, -1] - o[:, :, 0]).mean() + np.abs(o[:, -1] - o[:, 0]).mean()) / 2
    inner = (np.abs(np.diff(o, axis=2)).mean() + np.abs(np.diff(o, axis=1)).mean()) / 2
    phase = (np.abs(o[:, :, p::p] - o[:, :, p - 1:-1:p]).mean()
             + np.abs(o[:, p::p] - o[:, p - 1:-1:p]).mean()) / 2
    return float(seam / inner), float(seam / phase)


def tileable_paths(seed: int, main_counts, main_out, main_walls, cdf_counts,
                   card: str):
    """Phase 6d: tileable output at 512 px. Path T: the main path's
    defaults (chol, PCA, 5 passes, 500 iterations, real depth-3 weights,
    f32) with tileable=True, cold and warm, then one profiled run: every
    wrap kernel launched the main path's count of its reflect mode, no
    reflect codec kernel launched. Path T-bf16: the same at batch 8 in
    bf16 (kernels 1b-5b in wrap mode), cold and warm, one profiled run,
    then once with hist_mode="cdf" (the cdf kernels beside the wrap codec,
    path A's counts). The seam statistic (seam_ratio) of each output beside
    the main path's. Returns {kernel: launches} of T and of T-bf16, and
    path T's output."""
    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1)
    base = dict(size=512, seed=seed, style=["smoke_style"], tileable=True)
    out_counts = {}
    for tag, kw, suffix in (("path T, tileable", {}, "_wrap"),
                            ("path T-bf16, tileable, batch 8",
                             dict(batch=8, conv_dtype="bfloat16"), "_bf16_wrap")):
        cfg = OptexConfig(**base, **kw)
        counts, walls, out, peaks = drive_path(tag, cfg, [style])
        want = {k + suffix: main_counts[k] for k in _CODEC}
        reflect = {k: counts[k] for k in _CODEC + tuple(k + "_bf16" for k in _CODEC)
                   if counts[k]}
        if {k: counts[k] for k in want} != want or reflect:
            raise AssertionError(f"{tag}: launches {counts}: not the main path's "
                                 f"counts on the wrap kernels, or a reflect launch "
                                 f"{reflect}")
        if len({image.tobytes() for image in out}) != cfg.batch:
            raise AssertionError(f"{tag}: two images of the batch are equal")
        wall, busy = profile_run("tileable" + suffix.replace("_wrap", ""), cfg, [style])
        period = shift_period(cfg)
        seams = [seam_ratio(o[None], period) for o in out]
        main_seam = seam_ratio(main_out, period)
        print(f"{tag}: walls cold {walls[0]:.4f} s, warm {walls[1]:.4f} s "
              f"({cfg.batch / walls[1]:.2f} images/s warm), beside the main path's "
              f"{main_walls[0]:.4f} / {main_walls[1]:.4f} s; peak "
              f"{peaks[1] / 2**30:.2f} GiB; one profiled run: wall {wall:.4f} s, "
              f"device busy {busy:.1f} ms; launches {want} (the main path's, on "
              f"the wrap kernels), no reflect codec launch; seam ratio (vs all "
              f"neighbours, vs the seam's phase of the {period}-px grid) "
              f"{np.round(seams, 4).tolist()} (the "
              f"main path's output {np.round(main_seam, 4).tolist()}) [{card}]",
              flush=True)
        out_counts[suffix] = counts
        if suffix == "_wrap":
            t_out = out
    cfg = OptexConfig(**base, batch=8, conv_dtype="bfloat16", hist_mode="cdf")
    counts, walls, out, _ = drive_path("path T-bf16, tileable, batch 8, cdf", cfg,
                                       [style], labels=("warm",))
    for name in ("batched_histogram", "pwl_remap"):
        if counts[name] != cdf_counts[name]:
            raise AssertionError(f"path T-bf16 (cdf): {name} {counts[name]} != path "
                                 f"A's {cdf_counts[name]}")
    print(f"path T-bf16, cdf: wall {walls[0]:.4f} s; histogram and remap "
          f"{counts['batched_histogram']} launches each (path A's) beside the wrap "
          f"codec's {_codec_part(counts, '_bf16_wrap')}; seam ratio "
          f"{np.round([seam_ratio(o[None], shift_period(cfg)) for o in out], 4).tolist()} "
          f"[{card}]",
          flush=True)
    return out_counts, t_out


def equivariance_phase(seed: int):
    """Phase 6e: JAX tests/test_tileable.py's shift-equivariance check on
    the kernels. 64 px, depth 2 (the real weights), one pass of 6
    iterations, noise rolled by 16 px: |run(roll(noise)) -
    roll(run(noise))| < 1e-2 in chol and cdf mode, the reflect run's error
    more than 10x the wrap run's; 2 passes with multires (64 -> 256 -> 64,
    the circular pass resizes) < 2e-2."""
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1, 64)
    noise = np.random.default_rng(seed + 7).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    m = 16
    roll = lambda a: np.roll(a, (m, m), (1, 2))

    def error(tileable, **extra):
        kw = dict(size=64, passes=1, iters=6, no_multires=True, depth=2, seed=0,
                  style=["smoke_style"], tileable=tileable)
        kw.update(extra)
        cfg = OptexConfig(**kw)
        _reset_counts()
        out = core.Synthesizer(cfg, device="cuda").run(noise, [style]).cpu().numpy()
        shifted = core.Synthesizer(cfg, device="cuda").run(roll(noise),
                                                           [style]).cpu().numpy()
        launches = _counts()
        on = [k + "_wrap" * tileable for k in _CODEC]
        off = [k + "_wrap" * (not tileable) for k in _CODEC]
        if not all(launches[k] for k in on) or any(launches[k] for k in off):
            raise AssertionError(f"equivariance run (tileable={tileable}): "
                                 f"launches {launches}")
        return float(np.abs(shifted - roll(out)).max())

    for mode in ("chol", "cdf"):
        wrap, reflect = error(True, hist_mode=mode), error(False, hist_mode=mode)
        print(f"equivariance on the kernels, {mode}: max |run(roll) - roll(run)| "
              f"{wrap:.3e} tileable (bound 1e-2), {reflect:.3e} reflect "
              f"({reflect / max(wrap, 1e-12):.1f}x)", flush=True)
        if not (wrap < 1e-2 and reflect > 10 * max(wrap, 1e-4)):
            raise AssertionError(f"equivariance ({mode}): wrap {wrap}, reflect {reflect}")
    multi = error(True, no_multires=False, passes=2, iters=4)
    print(f"equivariance on the kernels, multires 64 -> 256 -> 64: {multi:.3e} "
          f"(bound 2e-2)", flush=True)
    if not multi < 2e-2:
        raise AssertionError(f"equivariance (multires): {multi}")


def _rotation_stream(seed: int):
    """Deterministic SO(n) stacks per (pass, stage) from numpy (QR with the
    sign fix), as tests/test_torch_slice.py's RotationStream draws them."""
    cache = {}

    def rotations(p, i, n_iters, n):
        if (p, i) not in cache:
            rng = np.random.default_rng([seed, p, i])
            qs = []
            for _ in range(n_iters):
                q, r = np.linalg.qr(rng.standard_normal((n, n)))
                q = q * np.sign(np.diag(r))[None, :]
                if np.linalg.det(q) < 0:
                    q[:, -1] *= -1
                qs.append(q)
            cache[(p, i)] = np.stack(qs).astype(np.float32)
        return cache[(p, i)]
    return rotations


def profile_run(name, cfg, styles, content=None, shapes=False):
    """One more warm run under torch.profiler: device busy time against the
    wall, the ported kernels' share, and the top device kernels (the whole
    table goes to profile_<name>.txt in the output directory; with
    ``shapes`` the ops' input shapes are recorded and a table of the cuDNN
    convolutions by input shape follows it). Returns (wall s, device busy
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from optimaltextures_tpu_torch import core

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as p:
        _, wall = core.synthesize(cfg, styles, content, device="cuda")
    rows = p.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only: an aten op's own row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    part = lambda key: sum(dev_us(e) for e in kernels if key in e.key) / 1e3
    convs = part('conv3x3_tf32x3') + part('conv3x3_wg')
    ups = part('upconv_tf32x3') + part('upconv_wg')
    tc = convs + ups
    # the edge convs: the f32 FFMA kernels (*_tma) and the bf16 mma.sync ones (*_mma)
    fin = part('final_to_rgb_tma') + part('final_to_rgb_mma')
    ent = part('rgb_to_relu1_tma') + part('rgb_to_relu1_mma')
    edge = fin + ent
    print(f"profile {name} (warm run, profiler on): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of the "
          f"wall), codec kernels {edge + tc:.1f} ms "
          f"(tensor-core {tc:.1f}: conv3x3_p2 + conv3x3_full "
          f"{convs:.1f}, upconv_p2 {ups:.1f}; "
          f"final_to_rgb {fin:.3f}, rgb_to_relu1 {ent:.3f}), "
          f"histogram kernel {part('histogram_cluster'):.2f} ms, pwl kernel "
          f"{part('pwl_tables'):.2f} ms; memset/fill kernels "
          f"{sum(e.count for e in kernels if 'Memset' in e.key or 'Fill' in e.key)}"
          f" launches", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="cuda_time_total", row_limit=80))
        if shapes:
            total_us = lambda e: getattr(e, "device_time_total",
                                         getattr(e, "cuda_time_total", 0.0))
            convs = [e for e in p.key_averages(group_by_input_shape=True)
                     if e.key == "aten::cudnn_convolution"]
            f.write("\n\naten::cudnn_convolution by input shape "
                    "(device us incl. children, calls, shapes)\n")
            for e in sorted(convs, key=total_us, reverse=True):
                f.write(f"{total_us(e):12.1f} {e.count:4d} {e.input_shapes}\n")
    torch.cuda.synchronize()
    return wall, busy


def _gpu_vs_cpu(cfg, seed: int, content_shape=None, pastiche=None):
    """``cfg`` at 64 px on the GPU (kernels) and on the CPU (plain
    versions): same noise (or ``pastiche``: an init image), styles (one per
    ``cfg.style``), content, and injected rotations and mixing masks."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops.rotation import polar_rotations

    rng = np.random.default_rng(seed)
    shape = content_shape or (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3)
    noise = rng.uniform(size=shape).astype(np.float32)
    if pastiche is not None:
        noise = pastiche
    styles = [_style_exemplar(seed + 2 + 5 * i, 64) for i in range(len(cfg.style))]
    content = (np.ascontiguousarray(_style_exemplar(seed + 4, 96)[:, :shape[1],
                                                                  :shape[2]])
               if content_shape else None)
    color = polar_rotations(torch.as_tensor(
        rng.standard_normal((core.COLOR_STEPS, 3, 3)))).float().numpy()
    rots, masks = {}, {}

    def rotations(p, i, n_iters, c):
        if (p, i) not in rots:
            g = torch.as_tensor(rng.standard_normal((n_iters, c, c)))
            rots[(p, i)] = polar_rotations(g).float().numpy()
        return rots[(p, i)]

    def mix_draws(p, hw, n_styles):
        if p not in masks:
            masks[p] = rng.integers(0, n_styles, size=hw)
        return masks[p]

    outs = {}
    for dev in ("cpu", "cuda"):
        _reset_counts()
        outs[dev] = core.Synthesizer(cfg, device=dev).run(
            noise, styles, content, rotations=rotations,
            color_rotations=color, mix_draws=mix_draws).cpu().numpy()
        launches = _counts()
        if dev == "cpu" and any(launches.values()):
            raise AssertionError(f"the CPU run counted launches: {launches}")
    expected = {k: v for k, v in expected_counts(cfg).items() if v}
    if any(launches[k] == 0 for k in expected):
        raise AssertionError(f"the 64-px GPU run skipped a kernel: {launches}")
    return outs["cuda"], outs["cpu"]


def _hold_max(name: str, gpu, cpu, bound: float = 1e-3) -> None:
    err = float(np.abs(gpu - cpu).max())
    print(f"{name}, GPU (kernels) vs CPU (plain): max abs diff {err:.3e}",
          flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: GPU vs CPU diff {err} > {bound}")


def _hold_distribution(name: str, gpu, cpu, what: str = "GPU vs CPU") -> None:
    """cdf runs: a sample a rounding apart lands in the next bin and the
    runs then diverge pixel by pixel, so hold the output's distribution."""
    g, c = gpu.reshape(-1, 3), cpu.reshape(-1, 3)
    stats = (float(np.abs(g.mean(0) - c.mean(0)).max()),
             float(np.abs(g.std(0) - c.std(0)).max()),
             float(np.abs(np.sort(g, 0) - np.sort(c, 0)).mean()))
    print(f"{name}, {what}: max abs diff "
          f"{float(np.abs(gpu - cpu).max()):.3e}, per-channel mean diff "
          f"{stats[0]:.3e}, std diff {stats[1]:.3e}, sorted-pixel mean diff "
          f"{stats[2]:.3e}", flush=True)
    if not (np.isfinite(gpu).all() and stats[0] <= 3e-3 and stats[1] <= 1e-2
            and stats[2] <= 1e-2):
        raise AssertionError(f"{name}: {what} distribution {stats}")


def small_agreement(seed: int):
    """Phase 7: the port at 64 px on the GPU (kernels) vs the CPU (plain
    versions), same inputs, injected rotations and mixing masks, no PCA."""
    from optimaltextures_tpu_torch.config import OptexConfig

    kw = dict(size=64, no_pca=True, no_multires=True, seed=seed)
    _hold_max("64-px main path", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, style=["smoke_style"], **kw), seed))
    _hold_distribution("64-px cdf synthesis", *_gpu_vs_cpu(OptexConfig(
        passes=1, iters=60, hist_mode="cdf", style=["smoke_style"], **kw), seed))
    pair = ["smoke_style", "smoke_style_b"]
    _hold_max("64-px two-style mixing", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, style=pair, **kw), seed))
    _hold_max("64-px main path, batch 2, bf16", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, batch=2, conv_dtype="bfloat16",
        style=["smoke_style"], **kw), seed), BF16_RUN_GAP)
    _hold_distribution("64-px two-style cdf mixing", *_gpu_vs_cpu(OptexConfig(
        passes=1, iters=60, hist_mode="cdf", style=pair, **kw), seed))
    # the settings of phase 6c
    _hold_max("64x128 out_width", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, out_width=128, style=["smoke_style"], **kw), seed))
    _hold_max("64-px init", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, init="smoke_init", style=["smoke_style"], **kw),
        seed, pastiche=_style_exemplar(seed + 7, 64)))
    _hold_max("64-px cov_propagation=False", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, cov_propagation=False, style=["smoke_style"],
        **kw), seed))
    _hold_max("64-px batch 4, batch_chunk 2, f32", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, batch=4, batch_chunk=2, style=["smoke_style"],
        **kw), seed))
    # tileable: the wrap kernels against the plain versions in wrap mode
    _hold_max("64-px tileable", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, tileable=True, style=["smoke_style"], **kw), seed))
    _hold_max("64-px tileable, multires (64 -> 256 -> 64, circular resizes)",
              *_gpu_vs_cpu(OptexConfig(size=64, passes=2, iters=48, no_pca=True,
                                       seed=seed, tileable=True,
                                       style=["smoke_style"]), seed))
    _hold_max("64-px tileable, batch 2, bf16", *_gpu_vs_cpu(OptexConfig(
        passes=2, iters=48, batch=2, conv_dtype="bfloat16", tileable=True,
        style=["smoke_style"], **kw), seed), BF16_RUN_GAP)
    _hold_distribution("64-px tileable cdf synthesis", *_gpu_vs_cpu(OptexConfig(
        passes=1, iters=60, hist_mode="cdf", tileable=True, style=["smoke_style"],
        **kw), seed))

    gpu, cpu = _gpu_vs_cpu(OptexConfig(
        size=96, passes=2, iters=60, no_pca=True, seed=seed,
        content="smoke_content", content_strength=0.2, color_transfer="opt",
        style=["smoke_style"]), seed, (1, 64, 96, 3))
    diff = np.abs(gpu - cpu)
    print(f"64x96 transfer + opt, GPU vs CPU: max abs diff "
          f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}", flush=True)
    if not (float(diff.mean()) <= 3e-3 and float(diff.max()) <= 5e-2):
        raise AssertionError("64x96 transfer + opt GPU vs CPU: max "
                             f"{float(diff.max())}, mean {float(diff.mean())}")


def cli_phase(seed: int):
    """Phase 8: the CLI end to end on a style file, then mixing two style
    files; a PNG must appear each time."""
    from optimaltextures_tpu_torch import cli

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    for styles, tag in (([SAMPLE_STYLE], "cholhist"),
                        ([SAMPLE_STYLE, SAMPLE_STYLE_B], "blend0.5")):
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                                   dir=os.path.join(REPO, "build"))
        rc = cli.main(["--style", *styles, "--size", "512", "--seed", str(seed),
                       "--output_dir", out_dir, "--quiet"])
        pngs = [f for f in os.listdir(out_dir) if f.endswith(".png")]
        if rc != 0 or len(pngs) != 1 or tag not in pngs[0]:
            raise AssertionError(f"cli returned {rc}, wrote {pngs}")
        print(f"cli: wrote {os.path.join(out_dir, pngs[0])}", flush=True)


class _Server:
    """serve.serve(port=0, ...) on a thread of this process; ``post`` sends
    one request and returns (status, headers, body, seconds)."""

    def __init__(self, **kw):
        import threading

        from optimaltextures_tpu_torch import serve

        self.srv = serve.serve(port=0, **kw)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def post(self, payload):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/v1/synthesize", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.time()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.headers, r.read(), time.time() - t0
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read(), time.time() - t0

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(f"{self.url}{path}", timeout=60) as r:
            return r.read()

    def metrics(self):
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in self.get("/metrics").decode().splitlines()
                if not ln.startswith("#")}

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()


def _served_ok(name, status, headers, body, seconds, expected, preps=None,
               want_preps=None):
    """A request's checks: 200, and the launches of the run it made (counts
    set to 0 just before it) equal to ``expected``; ``want_preps`` the style
    preps it may dispatch."""
    launches = _counts()
    print(f"serve, {name}: {seconds:.4f} s, HTTP {status}, "
          f"{headers.get('Content-Type')}, {len(body)} bytes, style preps "
          f"{preps}, launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    if status != 200:
        raise AssertionError(f"serve, {name}: HTTP {status}: {body[:300]!r}")
    if launches != expected:
        raise AssertionError(f"serve, {name}: launches {launches} != "
                             f"expected {expected}")
    if want_preps is not None and preps != want_preps:
        raise AssertionError(f"serve, {name}: {preps} style preps dispatched, "
                             f"expected {want_preps}")


def _cohort(server, payload, n, expected, name, card):
    """n unseeded requests queued behind the server's only worker (checked
    out here) until the open cohort holds all n, then run as one batched
    run. Returns the bodies and the wall from the check-in to the last
    response."""
    import concurrent.futures

    workers, co = server.srv.workers, server.srv.coalescer
    idx = workers.checkout()
    _reset_counts()
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(server.post, payload) for _ in range(n)]
        t_wait = time.time()
        while True:
            with co.lock:
                sizes = [len(c) for c in co._open.values()]
            if sizes == [n]:
                break
            if time.time() - t_wait > 120:
                raise AssertionError(f"serve, {name}: the open cohorts hold "
                                     f"{sizes}, not {n}")
            time.sleep(0.01)
        t0 = time.time()
        workers.checkin(idx)
        results = [f.result() for f in futs]
    wall = time.time() - t0
    launches = _counts()
    bodies = [body for _, _, body, _ in results]
    cohorts = [h.get("X-Optex-Cohort") for _, h, _, _ in results]
    print(f"serve, {name}: {n} requests in one cohort, wall {wall:.4f} s "
          f"({n / wall:.2f} images/s), {len(set(bodies))} distinct images, "
          f"launches {({k: v for k, v in launches.items() if v})} [{card}]",
          flush=True)
    if any(s != 200 for s, _, _, _ in results) or cohorts != [str(n)] * n:
        raise AssertionError(f"serve, {name}: statuses "
                             f"{[s for s, _, _, _ in results]}, cohorts {cohorts}")
    if len(set(bodies)) != n:
        raise AssertionError(f"serve, {name}: only {len(set(bodies))} of {n} "
                             "images differ")
    if launches != expected:
        raise AssertionError(f"serve, {name}: launches {launches} != "
                             f"{expected} (the batch-1 counts)")
    return bodies, wall


def serve_phase(seed: int, card: str):
    """Phase 9: the HTTP server (optimaltextures_tpu_torch/serve.py) on the
    GPU at 512 px with the main path's defaults, the style exemplar from
    ``seed`` sent as a base64 PNG: cold and warm seeded requests byte-equal
    to a direct run, the styles_token cache, a pack restart, coalesced
    cohorts of 8 in f32 and bf16, a cdf request, the response formats,
    /healthz, /metrics and a multi-device request's 400 (one worker). Every
    request's launches are counted."""
    import base64
    import io

    import torch
    from PIL import Image

    from optimaltextures_tpu_torch import core, serve
    from optimaltextures_tpu_torch.config import OptexConfig

    style_u8 = (np.clip(_style_exemplar(seed + 1)[0], 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(style_u8).save(buf, "PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    base = {"size": 512}
    main_cfg = OptexConfig(size=512, seed=seed, style=["smoke_style"])
    main = expected_counts(main_cfg)
    bf16 = expected_counts(OptexConfig(size=512, conv_dtype="bfloat16",
                                       style=["smoke_style"]))
    tile_counts = expected_counts(OptexConfig(size=512, tileable=True,
                                              style=["smoke_style"]))
    cdf_counts = expected_counts(OptexConfig(size=512, hist_mode="cdf",
                                             style=["smoke_style"]))
    pixels = lambda body: np.asarray(Image.open(io.BytesIO(body)))

    inner, preps = core.Synthesizer._dispatch_style_prep, [0]

    def counted_prep(self, *args):
        preps[0] += 1
        return inner(self, *args)

    def request(server, name, payload, expected=main, want_preps=None):
        _reset_counts()
        n0 = preps[0]
        status, headers, body, seconds = server.post(payload)
        _served_ok(name, status, headers, body, seconds, expected,
                   preps[0] - n0, want_preps)
        return body, seconds, preps[0] - n0

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    pack_dir = tempfile.mkdtemp(prefix="chip_smoke_packs_",
                                dir=os.path.join(REPO, "build"))
    os.environ["OPTEX_PACK_DIR"] = pack_dir
    core.Synthesizer._dispatch_style_prep = counted_prep
    seeded = {"config": {**base, "seed": seed}, "style_b64": [b64]}
    unseeded = {"config": base, "style_b64": [b64]}
    servers = []
    try:
        # the first server: cold, then warm seeded requests
        first = _Server()
        servers.append(first)
        cold, cold_s, cold_preps = request(first, "cold seeded request", seeded)
        if not cold_preps:
            raise AssertionError("serve: the cold request dispatched no style prep")
        packs = os.listdir(pack_dir)
        if len(packs) != 1:
            raise AssertionError(f"serve: the first request wrote packs {packs}")
        warm, warm_s = [], []
        for i in range(8):
            body, seconds, _ = request(first, f"warm seeded request {i + 1}",
                                       seeded, want_preps=0)
            warm.append(body)
            warm_s.append(seconds)
        if any(b != cold for b in warm):
            raise AssertionError("serve: seeded responses differ")
        synth = core.Synthesizer(main_cfg, device="cuda")
        key = synth.next_run_key()
        style = serve._decode_image(b64, 512, oversize=True)
        noise = core.draw_noise(synth.device, key, (1, 512, 512, 3))
        direct = synth.run(noise, [style], key=key, quantize_uint8=True).cpu().numpy()
        del synth
        served = pixels(cold)
        if served.shape != (512, 512, 3) or not np.array_equal(served, direct[0]):
            raise AssertionError(
                f"serve: the served image {served.shape} is not the direct run's "
                f"({int((served != direct[0]).sum())} bytes differ)")
        p50 = float(np.median(warm_s))
        print(f"serve: cold seeded request {cold_s:.4f} s (Synthesizer built, "
              f"{cold_preps} style preps; the kernels were built in phase 2, so no nvcc), warm "
              f"seeded p50 {p50:.4f} s, max {max(warm_s):.4f} s over 8; every "
              f"body identical and byte-equal to a direct Synthesizer.run "
              f"(key={seed}, quantize_uint8=True); the warm requests dispatched "
              f"no style prep (styles_token cache) [{card}]", flush=True)
        # the host's share of a warm request, each part timed alone in turn
        t0 = time.time()
        req = serve._parse_request(seeded)
        parse_s = time.time() - t0
        _reset_counts()
        t0 = time.time()
        serve._execute(first.srv.workers.pools[0], req)
        execute_s = time.time() - t0
        if _counts() != main:
            raise AssertionError(f"serve: _execute launched {_counts()}")
        t0 = time.time()
        serve._encode_batch(direct, "png")
        encode_s = time.time() - t0
        print(f"serve, a warm seeded request's parts: parse (base64 + PNG "
              f"decode + resize + token) {parse_s:.4f} s; _execute {execute_s:.4f} "
              f"s (the tokened run, the uint8 fetch, the PNG encode), of it the "
              f"512^2 PNG encode {encode_s:.4f} s; HTTP and JSON the rest of the "
              f"p50, {p50 - parse_s - execute_s:.4f} s [{card}]", flush=True)
        a, _, _ = request(first, "unseeded request 1", unseeded, want_preps=0)
        b, _, _ = request(first, "unseeded request 2", unseeded, want_preps=0)
        if a == b:
            raise AssertionError("serve: two unseeded requests returned the same bytes")
        cdf_s = [request(first, f"cdf request ({label})",
                         {"config": {**base, "seed": seed, "hist_mode": "cdf"},
                          "style_b64": [b64]}, cdf_counts)[1]
                 for label in ("cold", "warm")]
        jpeg, _, _ = request(first, "jpeg", {**seeded, "format": "jpeg"},
                             want_preps=0)
        npy, _, _ = request(first, "npy", {**seeded, "format": "npy"}, want_preps=0)
        jerr = np.abs(pixels(jpeg).astype(np.int16) - served.astype(np.int16)).mean()
        arr = np.load(io.BytesIO(npy))
        if jpeg[:2] != b"\xff\xd8" or jerr > 30 or not np.array_equal(arr[0], served):
            raise AssertionError(f"serve: jpeg mean error {jerr}, npy {arr.shape}")
        status, _, body, _ = first.post({"config": {**base, "spatial_devices": 2},
                                         "style_b64": [b64]})
        if (status != 400 or "requested 2 devices, have 1" not in json.loads(body)["error"]
                or list(first.srv.workers._free) != [0]):
            raise AssertionError(f"serve: spatial_devices 2 on one worker gave HTTP "
                                 f"{status}: {body!r}")
        tile, tile_s, _ = request(first, "tileable request",
                                  {"config": {**base, "seed": seed, "tileable": True},
                                   "style_b64": [b64]}, tile_counts)
        if pixels(tile).shape != (512, 512, 3):
            raise AssertionError(f"serve: the tileable image is {pixels(tile).shape}")
        health = json.loads(first.get("/healthz"))
        metrics = first.metrics()
        want = {'optex_requests_total{outcome="ok"}': 16.0,
                'optex_requests_total{outcome="client_error"}': 1.0,
                'optex_requests_total{outcome="server_error"}': 0.0,
                "optex_request_seconds_count": 16.0, "optex_workers": 1.0,
                "optex_coalesced_cohorts_total": 0.0,
                "optex_coalesced_requests_total": 0.0}
        print(f"serve: cdf request {cdf_s[0]:.4f} s cold (a new Synthesizer), "
              f"{cdf_s[1]:.4f} s warm; jpeg mean |error| {jerr:.2f}, npy equal to "
              f"the png; tileable {tile_s:.4f} s cold (a new Synthesizer; the wrap "
              f"kernels at the main path's counts, seam ratio "
              f"{np.round(seam_ratio(pixels(tile)[None] / 255.0), 4).tolist()}); "
              f"spatial_devices 2 on one worker "
              f"400; /healthz {health}; /metrics "
              f"{ {k: metrics[k] for k in want} } [{card}]", flush=True)
        if health["devices"] != [torch.cuda.get_device_name(0)] or any(
                metrics[k] != v for k, v in want.items()):
            raise AssertionError(f"serve: /healthz {health}, /metrics {metrics}")

        # a restarted server: fresh pools, the pack on disk
        second = _Server()
        servers.append(second)
        restart, restart_s, _ = request(
            second, "first request after the restart", seeded, want_preps=0)
        if restart != cold:
            raise AssertionError("serve: the restarted server's bytes differ")
        print(f"serve: first request after the pack restart {restart_s:.4f} s "
              f"(a new Synthesizer, the pack imported: 0 style preps; the same "
              f"bytes) [{card}]", flush=True)
        walls, cohort_preps = {}, {}
        for label in ("cold", "warm"):
            n0 = preps[0]
            _, walls[f"f32 {label}"] = _cohort(
                second, unseeded, 8, main, f"f32 cohort ({label})", card)
            cohort_preps[f"f32 {label}"] = preps[0] - n0
        m = second.metrics()
        if (m["optex_coalesced_cohorts_total"], m["optex_coalesced_requests_total"]) != (2, 16):
            raise AssertionError(f"serve: coalescing counters {m}")

        # bf16 by operator default; no pack directory: a pack is keyed by a
        # signature without conv_dtype, so this server computes its own
        # bf16 statistics
        del os.environ["OPTEX_PACK_DIR"]
        third = _Server(config_defaults={"conv_dtype": "bfloat16"})
        servers.append(third)
        for label in ("cold", "warm"):
            n0 = preps[0]
            _, walls[f"bf16 {label}"] = _cohort(
                third, unseeded, 8, bf16, f"bf16 cohort ({label})", card)
            cohort_preps[f"bf16 {label}"] = preps[0] - n0
        print("serve: cohorts of 8 (padded batch 8), wall s / images/s: "
              + "; ".join(f"{k} {w:.4f} / {8 / w:.2f}" for k, w in walls.items())
              + f"; beside 8 warm single requests in turn, 8 x p50 = {8 * p50:.4f} s "
              f"({1 / p50:.2f} images/s); style preps {cohort_preps} [{card}]",
              flush=True)
        if (cohort_preps["f32 cold"], cohort_preps["f32 warm"],
                cohort_preps["bf16 warm"]) != (0, 0, 0) or not cohort_preps["bf16 cold"]:
            raise AssertionError(f"serve: cohort style preps {cohort_preps}")
    finally:
        core.Synthesizer._dispatch_style_prep = inner
        os.environ.pop("OPTEX_PACK_DIR", None)
        for s in servers:
            s.close()
    torch.cuda.empty_cache()


def _rank_counts_ok(name, counts, want, keys):
    """Each rank's launches of ``keys`` must be ``want``'s."""
    for r, c in enumerate(counts):
        got = {k: c[k] for k in keys}
        if got != {k: want[k] for k in keys}:
            raise AssertionError(f"{name}: rank {r} launched {got}, not "
                                 f"{ {k: want[k] for k in keys} }")


def dp_phase(seed: int, card: str, main_counts, main_out, cdf_counts,
             slice_counts):
    """Phase 10: data parallelism on this card (gloo ranks sharing it, one
    NCCL rank) and, with two or more cards, NCCL across them. Each rank's
    launch counts are set to 0 just before its run and read just after.
    Returns {run: its warm wall} for phase 12."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.parallel.style_dp import \
        synthesize_style_batch
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    style = _style_exemplar(seed + 1)
    pair = [style, _style_exemplar(seed + 5)]
    main = dict(size=512, seed=seed, style=["smoke_style"])
    sp = dict(main, style=["smoke_style", "smoke_style_b"])
    codec_f32 = [k for k in main_counts if k in _CODEC]
    codec_bf16 = [k + "_bf16" for k in _CODEC]
    cdf_keys = ["batched_histogram", "pwl_remap", "rotate_rows", "unrotate_rows"]

    # the same runs in this process, before the ranks take the card
    def here(**kw):
        out, _ = core.synthesize(OptexConfig(**{**main, **kw}), [style],
                                 device="cuda")
        return out.cpu().numpy()

    ref = here(batch=2)
    ref_cdf = here(batch=2, hist_mode="cdf")
    # bf16 at 512 px over the full schedule: another summation order of the
    # Gram (the batch in two halves, as the two ranks sum it, or batch_chunk
    # does) flips bf16 roundings that five passes carry on, so the batch-256
    # run in one process and its run in chunks of 128 part pixel by pixel
    # (mean |diff| ~8e-3). The DP run is held to that run's distribution and
    # to that gap.
    ref_bf16 = here(batch=256, conv_dtype="bfloat16")
    chunk_gap = np.abs(here(batch=256, conv_dtype="bfloat16",
                            batch_chunk=128) - ref_bf16)
    ref_sp = synthesize_style_batch(OptexConfig(**sp), pair, None,
                                    device="cuda").cpu().numpy()
    torch.cuda.empty_cache()

    t0 = time.time()
    got = spawn(dr.jobs, 2, backend="gloo", device="cuda:0", args=([
        ("run_rank", ({**main, "batch": 2, "num_devices": 2}, [style])),
        ("run_rank", ({**main, "batch": 2, "num_devices": 2,
                       "hist_mode": "cdf"}, [style], ("warm",))),
        ("run_rank", ({**main, "batch": 256, "num_devices": 2,
                       "conv_dtype": "bfloat16"}, [style])),
        ("style_rank", ({**sp, "num_devices": 2}, pair, ("warm",)))],),
        deadline_s=900)
    print(f"phase 10: 2 gloo ranks on cuda:0 ({card}), {time.time() - t0:.1f} "
          f"s from the spawn to the last result, the ranks' start included",
          flush=True)
    f32, cdf_run, bf16, sp_run = got

    _rank_counts_ok("DP f32", f32["counts"], main_counts, codec_f32 + cdf_keys)
    err = float(np.abs(f32["out"] - ref).max())
    print(f"DP batch 2 f32, 2 gloo ranks sharing one card (not DP scaling): "
          f"walls cold {f32['walls'][0]:.4f} s, warm {f32['walls'][1]:.4f} s; "
          f"each rank's launches the batch-1 main path's {main_counts}; "
          f"max |DP - one process| {err:.3e} (bound 2e-3)", flush=True)
    if not (f32["out"].shape == (2, 512, 512, 3) and err <= 2e-3):
        raise AssertionError(f"DP f32: {f32['out'].shape}, error {err}")
    walls = {"phase 10 DP batch 2 f32 (one-shot spawn)": f32["walls"][1]}

    _rank_counts_ok("DP cdf", cdf_run["counts"], {**main_counts, **cdf_counts},
                    codec_f32 + cdf_keys)
    print(f"DP batch 2 cdf, 2 gloo ranks: warm {cdf_run['walls'][0]:.4f} s; "
          f"each rank's histogram and remap launches path A's "
          f"{ {k: cdf_counts[k] for k in cdf_keys} }", flush=True)
    _hold_distribution("DP batch 2 cdf", cdf_run["out"], ref_cdf,
                       "2 ranks vs one process")

    _rank_counts_ok("DP bf16", bf16["counts"], slice_counts,
                    codec_bf16 + codec_f32)
    gap = np.abs(bf16["out"] - ref_bf16)
    w = bf16["walls"]
    print(f"DP batch 256 bf16, 128 a rank, 2 gloo ranks sharing one card (not "
          f"DP scaling): walls cold {w[0]:.4f} s, warm {w[1]:.4f} s; "
          f"{256 / w[0]:.1f} and {256 / w[1]:.1f} images/s; each rank's peak "
          f"memory {[round(p / 2 ** 30, 2) for p in bf16['peaks']]} GiB; "
          f"launches the slice path's; |DP - one process| max "
          f"{float(gap.max()):.4f}, mean {float(gap.mean()):.3e}, beside "
          f"|chunks of 128 - one process| max {float(chunk_gap.max()):.4f}, "
          f"mean {float(chunk_gap.mean()):.3e} (bound 1.5x that mean)",
          flush=True)
    if not (bf16["out"].shape == (256, 512, 512, 3)
            and gap.mean() <= 1.5 * chunk_gap.mean()):
        raise AssertionError(f"DP bf16: {bf16['out'].shape}, mean gap "
                             f"{gap.mean()} vs the chunked run's "
                             f"{chunk_gap.mean()}")
    _hold_distribution("DP batch 256 bf16", bf16["out"], ref_bf16,
                       "2 ranks vs one process")
    del got, bf16, gap, chunk_gap, ref_bf16

    _rank_counts_ok("style-parallel", sp_run["counts"], main_counts,
                    codec_f32 + cdf_keys)
    err = float(np.abs(sp_run["out"] - ref_sp).max())
    print(f"style-parallel, 2 styles on 2 gloo ranks: warm "
          f"{sp_run['walls'][0]:.4f} s; each rank's launches one main path's; "
          f"max |ranks - one process| {err:.3e} (bound 2e-3)", flush=True)
    if not (sp_run["out"].shape == (2, 512, 512, 3) and err <= 2e-3):
        raise AssertionError(f"style-parallel: error {err}")

    nccl = spawn(dr.jobs, 1, backend="nccl", device="cuda:0", args=([
        ("run_rank", ({**main, "num_devices": 1}, [style]))],),
        deadline_s=600)[0]
    _rank_counts_ok("one NCCL rank", nccl["counts"], main_counts,
                    codec_f32 + cdf_keys)
    err = float(np.abs(nccl["out"] - main_out).max())
    print(f"one NCCL rank, the main path through the mesh: cold "
          f"{nccl['walls'][0]:.4f} s, warm {nccl['walls'][1]:.4f} s; max "
          f"|mesh - phase 6| {err:.3e} (bound 2e-3)", flush=True)
    if not err <= 2e-3:
        raise AssertionError(f"one NCCL rank: error {err}")

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print("phase 10, NCCL across cards: skipped, this machine has one "
              "card", flush=True)
        return walls
    f32, bf16 = spawn(dr.jobs, n, backend="nccl", device="cuda", args=([
        ("run_rank", ({**main, "batch": n, "num_devices": n}, [style])),
        ("run_rank", ({**main, "batch": 128 * n, "num_devices": n,
                       "conv_dtype": "bfloat16"}, [style]))],),
        deadline_s=900)
    _rank_counts_ok(f"NCCL x{n} f32", f32["counts"], main_counts,
                    codec_f32 + cdf_keys)
    _rank_counts_ok(f"NCCL x{n} bf16", bf16["counts"], slice_counts,
                    codec_bf16 + codec_f32)
    for name, r, images in ((f"batch {n} f32", f32, n),
                            (f"batch {128 * n} bf16", bf16, 128 * n)):
        if not np.isfinite(r["out"]).all() or r["out"].shape[0] != images:
            raise AssertionError(f"NCCL x{n} {name}: bad output")
        w = r["walls"]
        print(f"DP {name} on {n} cards (NCCL, {card}): walls cold {w[0]:.4f} "
              f"s, warm {w[1]:.4f} s; {images / w[0]:.1f} and "
              f"{images / w[1]:.1f} images/s; peak memory "
              f"{[round(p / 2 ** 30, 2) for p in r['peaks']]} GiB", flush=True)
    return walls


def spatial_phase(seed: int, card: str, main_counts, main_out, cdf_counts,
                  cdf_out, t_counts, t_out):
    """Phase 11: spatial sharding on this card. Two gloo ranks sharing it
    split one 512-px image's rows (spatial_devices 2, the main path's
    settings, f32): the main path cold and warm (within 2e-3 of phase 6's
    output, each rank's codec launches the main path's: the halo exchange
    launches no codec kernel), tileable on the wrap ring (within 2e-3 of
    path T's output, each rank's wrap launches path T's) and cdf (held to
    path A's output by distribution, each rank's histogram and remap
    launches path A's); then four gloo ranks run the 2 x 2 grid at 128 px,
    batch 2, against the same run in one process (2e-3); with two or more
    cards min(count, 4) NCCL ranks split the main path's image, else a line
    says that this step was skipped. Each rank's counts are set to 0 just
    before its run and read just after. Returns {kernel: (rank 0's launches
    on the spatial path, the run's name)} and {run: its warm wall}."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    t0 = time.time()
    style = _style_exemplar(seed + 1)
    main = dict(size=512, seed=seed, style=["smoke_style"], spatial_devices=2)
    codec_f32 = [k for k in main_counts if k in _CODEC]
    codec_wrap = [k + "_wrap" for k in _CODEC]
    cdf_keys = ["batched_histogram", "pwl_remap", "rotate_rows", "unrotate_rows"]
    grid = dict(size=128, seed=seed, style=["smoke_style"], batch=2)
    ref_grid = core.synthesize(OptexConfig(**grid), [style],
                               device="cuda")[0].cpu().numpy()
    torch.cuda.empty_cache()

    sp, tile, cdf_run = spawn(dr.jobs, 2, backend="gloo", device="cuda:0",
                              args=([
        ("run_rank", (main, [style])),
        ("run_rank", ({**main, "tileable": True}, [style], ("warm",))),
        ("run_rank", ({**main, "hist_mode": "cdf"}, [style], ("warm",)))],),
        deadline_s=600)
    t_sp = time.time() - t0
    _rank_counts_ok("spatial", sp["counts"], main_counts, codec_f32 + cdf_keys)
    err = float(np.abs(sp["out"] - main_out).max())
    print(f"spatial, 512 px on 2 gloo ranks sharing one card (not scaling): "
          f"walls cold {sp['walls'][0]:.4f} s, warm {sp['walls'][1]:.4f} s; "
          f"each rank's launches the main path's {main_counts} (the halo "
          f"exchange launches no codec kernel); peak memory "
          f"{[round(p / 2 ** 30, 2) for p in sp['peaks']]} GiB; max "
          f"|spatial - phase 6| {err:.3e} (bound 2e-3) [{card}]", flush=True)
    if not (sp["out"].shape == (1, 512, 512, 3) and err <= 2e-3):
        raise AssertionError(f"spatial: {sp['out'].shape}, error {err}")

    _rank_counts_ok("spatial tileable", tile["counts"], t_counts,
                    codec_wrap + codec_f32)
    err = float(np.abs(tile["out"] - t_out).max())
    print(f"spatial tileable (the wrap ring), 2 gloo ranks: warm "
          f"{tile['walls'][0]:.4f} s; each rank's wrap launches path T's; max "
          f"|spatial - path T| {err:.3e} (bound 2e-3)", flush=True)
    if not (tile["out"].shape == (1, 512, 512, 3) and err <= 2e-3):
        raise AssertionError(f"spatial tileable: error {err}")

    _rank_counts_ok("spatial cdf", cdf_run["counts"],
                    {**main_counts, **cdf_counts}, codec_f32 + cdf_keys)
    print(f"spatial cdf, 2 gloo ranks: warm {cdf_run['walls'][0]:.4f} s; each "
          f"rank's histogram and remap launches path A's "
          f"{ {k: cdf_counts[k] for k in cdf_keys} }", flush=True)
    _hold_distribution("spatial cdf", cdf_run["out"], cdf_out,
                       "2 ranks vs path A")

    t1 = time.time()
    g = spawn(dr.run_rank, 4, backend="gloo", device="cuda:0", args=(
        {**grid, "num_devices": 2, "spatial_devices": 2}, [style],
        ("warm",)), deadline_s=600)
    _rank_counts_ok("grid", g["counts"], main_counts, codec_f32 + cdf_keys)
    err = float(np.abs(g["out"] - ref_grid).max())
    print(f"grid 2 x 2, 128 px, batch 2, 4 gloo ranks sharing one card: warm "
          f"{g['walls'][0]:.4f} s ({time.time() - t1:.1f} s with the ranks' "
          f"start); each rank's launches the main path's; max |grid - one "
          f"process| {err:.3e} (bound 2e-3)", flush=True)
    if not (g["out"].shape == (2, 128, 128, 3) and err <= 2e-3):
        raise AssertionError(f"grid: {g['out'].shape}, error {err}")

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print("phase 11, NCCL spatial across cards: skipped, this machine has "
              "one card", flush=True)
    else:
        r = spawn(dr.run_rank, n, backend="nccl", device="cuda", args=(
            {**main, "spatial_devices": n}, [style], ("warm",)),
            deadline_s=600)
        _rank_counts_ok(f"NCCL spatial x{n}", r["counts"], main_counts,
                        codec_f32 + cdf_keys)
        err = float(np.abs(r["out"] - main_out).max())
        print(f"spatial 512 px on {n} cards (NCCL, {card}): warm "
              f"{r['walls'][0]:.4f} s; max |spatial - phase 6| {err:.3e} "
              f"(bound 2e-3)", flush=True)
        if not err <= 2e-3:
            raise AssertionError(f"NCCL spatial: error {err}")
    print(f"phase 11: {time.time() - t0:.1f} s ({t_sp:.1f} s the 2-rank "
          f"spawn, the ranks' start included) [{card}]", flush=True)
    rows = {k: (sp["counts"][0][k], "phase 11, spatial main path")
            for k in codec_f32}
    rows.update({k: (tile["counts"][0][k], "phase 11, spatial tileable")
                 for k in codec_wrap})
    rows.update({k: (cdf_run["counts"][0][k], "phase 11, spatial cdf")
                 for k in cdf_keys})
    return rows, {"phase 11 spatial 512 px f32 (one-shot spawn)":
                  sp["walls"][1]}


def served_ranks_phase(seed: int, card: str, main_counts, cdf_counts,
                       walls: dict):
    """Phase 12: multi-device requests as the server runs them
    (optimaltextures_tpu_torch/serve.py on a parallel.mesh.RankGroup), at
    512 px with the main path's settings, the style exemplar from ``seed``
    sent as a base64 PNG and parsed by ``serve._parse_request``. A gloo
    group of two ranks sharing this card (NCCL refuses two ranks on one
    GPU) runs, through ``serve._run_on_group``: a seeded spatial_devices 2
    request cold and 3 warm, then a seeded num_devices 2 batch 2 request
    cold and 3 warm, each bit-equal to one ``mesh.spawn`` of
    ``core.synthesize`` on the same decoded arrays and seed (both
    references in one spawn), every rank at the main path's launches (its
    counts set to 0 just before each request), no style prep on a warm
    request, the same rank processes throughout; two unseeded spatial
    requests (they differ); a cdf spatial request (each rank's histogram
    and remap launches path A's); then ``close()`` ends every rank. With
    two or more cards an HTTP server with workers=2 (NCCL) answers the
    seeded spatial request within one uint8 level of the gloo output, else
    a line says that this step was skipped. Prints the served walls beside
    ``walls`` (phases 10 and 11) and its own clock."""
    import base64
    import dataclasses
    import io

    import torch
    from PIL import Image

    from optimaltextures_tpu_torch import core, serve
    from optimaltextures_tpu_torch.parallel.mesh import RankGroup, spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    t_phase = time.time()
    style_u8 = (np.clip(_style_exemplar(seed + 1)[0], 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(style_u8).save(buf, "PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    codec_f32 = [k for k in main_counts if k in _CODEC]
    keys = codec_f32 + ["batched_histogram", "pwl_remap", "rotate_rows",
                        "unrotate_rows"]

    def payload(**cfg):
        return {"config": {"size": 512, **cfg}, "style_b64": [b64],
                "format": "npy"}

    sp_req = serve._parse_request(payload(seed=seed, spatial_devices=2))
    dp_req = serve._parse_request(payload(seed=seed, num_devices=2, batch=2))
    t0 = time.time()
    refs = spawn(dr.jobs, 2, backend="gloo", device="cuda:0", args=([
        ("run_rank", (dataclasses.asdict(r.cfg), r.styles, ("once",)))
        for r in (sp_req, dp_req)],), deadline_s=600)
    t_refs = time.time() - t0
    ref_sp, ref_dp = (core._quant_u8(torch.from_numpy(r["out"])).numpy()
                      for r in refs)

    t0 = time.time()
    group = RankGroup(["cuda:0", "cuda:0"], backend="gloo")
    start_s = time.time() - t0
    pids = group.pids
    print(f"phase 12: a gloo rank group of 2 on cuda:0 started in {start_s:.4f} "
          f"s (pids {pids}); the one-shot references' spawn took {t_refs:.1f} s "
          f"[{card}]", flush=True)

    def served(name, req, want):
        t0 = time.time()
        batch, reports = serve._run_on_group(group, req)
        wall = time.time() - t0
        launches = [r["launches"] for r in reports]
        preps = [r["style_preps"] for r in reports]
        print(f"served {name}: {wall:.4f} s, style preps per rank {preps}, "
              f"rank 0's launches "
              f"{ {k: v for k, v in launches[0].items() if v} }", flush=True)
        _rank_counts_ok(f"served {name}", launches, want, keys)
        if group.pids != pids:
            raise AssertionError(f"served {name}: the ranks are {group.pids}, "
                                 f"not {pids}")
        return batch, wall, preps

    def seeded(name, req, ref):
        labels = ("cold", "warm 1", "warm 2", "warm 3")
        outs, ws = [], []
        for label in labels:
            batch, wall, preps = served(f"{name} ({label})", req, main_counts)
            if (label == "cold" and not all(preps)) or (label != "cold"
                                                        and any(preps)):
                raise AssertionError(f"served {name} ({label}): style preps "
                                     f"{preps}")
            outs.append(batch)
            ws.append(wall)
        for label, out in zip(labels, outs):
            if out.shape != ref.shape or not np.array_equal(out, ref):
                raise AssertionError(
                    f"served {name} ({label}): {out.shape}, "
                    f"{int((out != ref).sum()) if out.shape == ref.shape else '-'} "
                    f"bytes differ from the one-shot spawn's")
        print(f"served {name}: cold {ws[0]:.4f} s, warm {ws[1]:.4f}, "
              f"{ws[2]:.4f}, {ws[3]:.4f} s; every output bit-equal to the "
              f"one-shot spawn of core.synthesize; each rank at the main "
              f"path's launches; warm requests dispatch no style prep [{card}]",
              flush=True)
        return outs[0], ws

    try:
        sp_out, sp_walls = seeded("spatial_devices 2", sp_req, ref_sp)
        _, dp_walls = seeded("num_devices 2, batch 2", dp_req, ref_dp)
        a, _, _ = served("unseeded spatial 1", serve._parse_request(
            payload(spatial_devices=2)), main_counts)
        b, _, _ = served("unseeded spatial 2", serve._parse_request(
            payload(spatial_devices=2)), main_counts)
        if np.array_equal(a, b):
            raise AssertionError("served: two unseeded requests are equal")
        _, cdf_s, _ = served("cdf spatial", serve._parse_request(
            payload(seed=seed, spatial_devices=2, hist_mode="cdf")),
            {**main_counts, **cdf_counts})
    finally:
        group.close()
    if any(os.path.exists(f"/proc/{p}") for p in pids):
        raise AssertionError(f"served: ranks {pids} outlived close()")
    print(f"served on 2 gloo ranks sharing one card (not scaling), 512 px f32: "
          f"group start {start_s:.4f} s; spatial cold {sp_walls[0]:.4f} s, warm "
          f"{min(sp_walls[1:]):.4f}-{max(sp_walls[1:]):.4f} s; DP batch 2 cold "
          f"{dp_walls[0]:.4f} s, warm {min(dp_walls[1:]):.4f}-"
          f"{max(dp_walls[1:]):.4f} s; cdf spatial {cdf_s:.4f} s (cold); beside "
          + "; ".join(f"{k} warm {v:.4f} s" for k, v in walls.items())
          + f"; close() ended every rank [{card}]", flush=True)

    if torch.cuda.device_count() < 2:
        print("phase 12, served over HTTP on two cards (NCCL): skipped, this "
              "machine has one card", flush=True)
    else:
        server = _Server(workers=2)
        try:
            status, headers, body, seconds = server.post(
                payload(seed=seed, spatial_devices=2))
            group_pids = [p for g in server.srv.workers._groups.values()
                          for p in g.pids]
        finally:
            server.close()
        if status != 200 or headers["X-Optex-Worker"] != "0,1":
            raise AssertionError(f"served over NCCL: HTTP {status}: {body[:300]!r}")
        got = np.load(io.BytesIO(body))
        # 2e-3 (JAX's DP bound) x 255 < 1: a float gap within the bound moves a
        # pixel by at most one uint8 level
        err = int(np.abs(got.astype(np.int16) - sp_out.astype(np.int16)).max())
        print(f"served spatial_devices 2 over HTTP, workers=2 on 2 cards (NCCL): "
              f"{seconds:.4f} s cold (the group's start included); max |NCCL - "
              f"gloo| {err} uint8 levels (bound 1) [{card}]", flush=True)
        if got.shape != sp_out.shape or err > 1:
            raise AssertionError(f"served over NCCL: {got.shape}, {err} levels")
        if any(os.path.exists(f"/proc/{p}") for p in group_pids):
            raise AssertionError("served over NCCL: a rank outlived server_close()")
    print(f"phase 12: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one warm run "
                         "of each path (phase 6c: D, G, F traced k and H)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import cuda_build

    t_start = time.time()
    core.full_f32_precision()   # TF32 off: plain versions and F.conv2d in f32
    card = _smi()
    print(f"device: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    libraries = (*cuda_build.RUN_LIBRARIES, "conv64")
    libs = cuda_build.build(*libraries)
    print(f"built {', '.join(f'csrc/{n}.cu' for n in libraries)} in "
          f"{time.time() - t0:.1f} s (sm_90a, in parallel)", flush=True)
    for name, lib in zip(libraries, libs):
        with open(lib + ".log") as f:
            for line in f:
                if ("registers" in line or "spill" in line or "Compiling" in line
                        or "Performance Loss" in line):
                    print("  ptxas:", line.strip())
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if name in NO_SPILL and spills and spills.groups() != ("0", "0"):
                    raise AssertionError(f"csrc/{name}.cu spills: {line.strip()}")
    wg = ctypes.CDLL(libs[libraries.index("conv_wg")])
    print("conv_wg dynamic shared memory: "
          + ", ".join(f"{mode} Cin {c} {wg.optex_conv_wg_smem(up, c)} B"
                      for up, mode in ((0, "conv3x3_wg"), (1, "upconv_wg"))
                      for c in (64, 128)), flush=True)
    check_sass(libs)

    rows = check_kernels(args.seed, args.reps, card)
    rows.update(check_cdf_kernels(args.seed, args.reps * 10, card))
    rows.update(check_rot_gemm(args.reps // 2, card))
    rows.update(check_conv64(args.reps, card))
    rows.update(check_bf16_kernels(args.seed, args.reps, card))
    rows.update(check_kernels(args.seed, args.reps, card, pad="wrap"))
    rows.update(check_bf16_kernels(args.seed, args.reps, card, pad="wrap"))
    check_wrap_edges(args.seed)
    main_counts, cdf_counts, main_out, main_walls, cdf_out = paths(
        args.seed, args.profile)
    slice_counts = slice_path(args.seed, main_counts, main_out, args.profile)
    bf16_vs_f32_batch8()
    settings_paths(args.seed, main_counts, main_out, main_walls, args.profile)
    tile_counts, t_out = tileable_paths(args.seed, main_counts, main_out,
                                        main_walls, cdf_counts, card)
    equivariance_phase(args.seed)
    small_agreement(args.seed)
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    if have_pil:
        cli_phase(args.seed)
    else:
        print("cli phase not run: Pillow is not installed", flush=True)
    serve_phase(args.seed, card)   # needs Pillow: a request's images are PNGs
    walls = dp_phase(args.seed, card, main_counts, main_out, cdf_counts,
                     slice_counts)
    spatial_counts, sp_walls = spatial_phase(
        args.seed, card, main_counts, main_out, cdf_counts, cdf_out,
        tile_counts["_wrap"], t_out)
    served_ranks_phase(args.seed, card, main_counts, cdf_counts,
                       {**walls, **sp_walls})

    kernels = []
    for name, r in rows.items():
        if "launches" in r:     # on no path: its own check phase's launches
            launches, phase = r["launches"], f"{name} check phase"
        elif name.endswith("_bf16_wrap"):
            launches = tile_counts["_bf16_wrap"][name]
            phase = "path T-bf16 (tileable, batch 8, bf16)"
        elif name.endswith("_wrap"):
            launches, phase = tile_counts["_wrap"][name], "path T (tileable)"
        elif name.endswith("_bf16"):
            launches, phase = slice_counts[name], "slice path (batch 128, bf16)"
        elif name in SOURCES:
            launches, phase = cdf_counts[name], "path A (cdf synthesis)"
        else:
            launches, phase = main_counts[name], "main path"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"optimaltextures_tpu_torch/csrc/"
                      f"{SOURCES.get(name, 'codec')}.cu",
            "replaces": REPLACES[name], "design": DESIGNS.get(name, "ffma"),
            "launches": launches, "phase": phase,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"],
            "bound_by": "operations" if r["t_flops"] >= r["t_bytes"] else "bytes",
            "library_ms": r["lib_ms"],
            **({"device_ms": r["device_ms"]} if "device_ms" in r else {}),
            **({"reflect_device_ms": r["reflect_device_ms"]}
               if "reflect_device_ms" in r else {}),
            **({"device_ms_by_shape": r["device_ms_by_shape"]}
               if "device_ms_by_shape" in r else {}),
            **({"dtype": "bfloat16"} if "_bf16" in name else {}),
            **({"pad": "wrap"} if name.endswith("_wrap") else {}),
            **({"spatial_launches": spatial_counts[name][0],
                "spatial_phase": spatial_counts[name][1]}
               if name in spatial_counts else {})})
    print(f"chip_smoke: {time.time() - t_start:.1f} s from the first phase to "
          f"the last, the kernels' build included", flush=True)
    print(f"device: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
