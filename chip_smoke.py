"""Drive hifidiff_tpu_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; without a card it exits non-zero. Phases
(a failed check is reported where it happens and ends the run with a
non-zero code and no result line; a kernel that does not build or launch
raises at once):

  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from hifidiff_tpu_torch/csrc;
  3. `ln_film`, the warp and the fused small-map NAF block against their
     plain PyTorch versions on the card at every shape of the paths: the
     samplers' batch 128, and for `ln_film` and the warp the train steps'
     float32 maps at batch 32 and 8, `ln_film` with per-sample FiLM rows 4C
     apart as a training block gives them (the warp with identity, random,
     shear, zoom-in and out-of-bounds thetas, in f32 bit for bit; the block
     with bf16 and with int8 weights, on what it adds to its input, where
     three controls that each leave out a part of the block must fail),
     with both versions' times, the bound of each shape and, where one
     PyTorch call computes the same function, that call's time; each call
     also twice, bit for bit; `ln_film` and the warp timed on copies of
     their maps beyond the 50 MB L2, `ln_film` beside the nearest library
     route (`F.layer_norm` over a channels-last view and the FiLM's
     multiply-add, `layer_norm_route_ms`) and a streaming pass over the
     same bytes (`x.mul(1.5)`); for the block as a yardstick the
     time of its five products as `torch.matmul` on bf16 weights, and (at
     the end of the run) the time each of the chain's seven kernels adds;
  4. the exact refiner sampler at full width on seeded, perturbed random
     weights, batch 2 in f32 with TF32 off, on the card through the kernels
     and on the host CPU through the plain versions, compared; two control
     runs on the card (the FiLM left out; bf16) must fail the same limits;
  5. the same sampler with int8 denoiser weights (the blocks that fuse
     amplified first, so that each of their parts shows), fused small-map
     NAF blocks and fused GroupNorm+SiLU, batch 2: bf16 on the card through
     the kernels against float32 on the host CPU through the plain versions,
     on the same int8 weights, and against the same bf16 run on the card
     through the three plain versions, to within bf16 noise on the final
     latents and the faces; and every fused block of the first step against
     its plain version on the input the run gave it, on what the block adds
     to that input. Two control runs (the position mix cut to its centre
     tap; matmul_w8's column scales left out) must fail the limits. Then
     the cached sampler (`cache_interval=2`) on the same configuration
     against the host's f32 run of it, to the same limits; the uncached
     card run must fail them;
  10. (run after 5) the other paths at full width, batch 2, f32 with TF32
     off, NEW_PATH_STEPS steps, card vs host CPU to phase 4's limits:
     DPM-Solver++ (2M), `cache_interval=3`, `hoist_invariants=False`,
     `sample_posterior=False`, `clip_sample`, the three tiny seams at the
     JAX package's default widths, the monolithic `build_refiner_sampler`
     (also bit for bit against the split sampler on the card) and
     `build_unconditional_sampler` (its float faces to UNCOND_TOL). Each
     path's control must fail its limits: the exact DDIM run where the path
     adds an option, the FiLM left out where its math is the exact one's;
  6. batch 128, bf16, uint8 I/O, 50 DDIM steps, three configurations: the
     default path, int8 only, and int8 + fused blocks + fused GroupNorm+SiLU.
     For each: a warm-up call that records the shapes reaching every kernel
     wrapper, one call with the launch counts set to 0 before and read
     after, held against the counts the module tree gives; `matmul_w8` and
     `group_norm_silu` against their plain versions at every recorded shape
     (both also twice, bit for bit; `matmul_w8` beside `torch.matmul` on
     pre-dequantized bf16 weights, printed as `cublas_bf16_ms`: twice the
     weight bytes and not the same function, so no `library_ms`;
     `group_norm_silu` with the path each shape takes, on chip or
     streaming, and its cluster, timed on copies of its maps beyond L2);
     then, one configuration at a time, the stages captured as CUDA graphs
     (`warm_compile`: the launch counts of its warm-up and capture held to
     twice the eager call's), one replay held to the eager call bit for
     bit, and eager calls and replays timed in turns (faces/s as the median
     and the spread of the calls, per-stage ms of each, peak memory; the
     replays counted, and no launch from Python after the capture, so that
     a call that ran eagerly fails), the captures dropped before the next
     configuration. At the end of the run, one eager scan and one replayed
     scan of each configuration under `torch.profiler` for the card's own
     time in them: the median timed replay of the scan must stay within
     GRAPH_SCAN_RATIO of the replay's own time;
  11. (run after 6) under graphs, default configuration, batch 128: faces/s
     of DPM-Solver++ (2M) at 20 steps and of cached DDIM-50 at intervals 2
     and 3, each replay held to its eager call bit for bit;
  12. (run after 11, before anything is profiled) the server
     (`cli/serve.py`) at full width through `create_server`, at its
     defaults (batch 16, bf16, exact DDIM-50, clip 3.0) with buckets 1 and
     4, reading the seeded perturbed weights from reference-named torch
     files: three buckets x three stages captured and the warm-up's launch
     counts held to the module tree; each face served at concurrency 1 bit
     for bit against an eager call with the same (seed, counter) generator
     (the next counter's call must differ); a 3-request burst in one
     bucket-4 launch, each face against the eager call on the padded batch;
     every `ln_film` and warp call of an eager bucket-1 call against its
     plain version to phase 3's limits; every launch while serving a replay
     (the sampler's `replays` rise by the launches, no kernel launched from
     Python); then the load generator (`cli/serve_bench.py`) at
     concurrencies 1, 4, 16 and 32, 8 requests a client (p50 / p95 ms,
     faces/s, launches, mean fill, errors, which must be 0), the cold
     start by part, the card's memory after the warm-up, and the host's ms
     a launch outside the replay with what `_state_key` costs of it; with
     the captures dropped, a launch must raise. Before the server, on the
     same weight files, the eval CLI (`cli/test_refiner.py`) at its
     defaults (f32, batch 4, DDIM-50, clip 3.0) on procedural faces: finite
     PSNR and SSIM, and its kernels launched as the module tree gives;
  13. (run after 17 (a), before anything is profiled) the
     training CLIs through their `main`, eager, at their default widths and
     batches, each on `--procedural` two of its batches for one epoch,
     chained through their checkpoint directories in a temporary directory:
     `train_vae` (batch 64), `train_cr` (8), `pretrain_idc --cr-ckpt` (24),
     `test_idc` on both stage files, `pretrain_denoiser --vae-ckpt` (512)
     on images and then on cached latents without and with `--remat`, and
     `train_refiner` (32) on the four files for two epochs (its stage file
     is phase 14's). Checked: every logged value
     finite; every step's kernel launches as the module tree gives them
     (`--remat` runs each block's two `ln_film` once more); the refiner as
     `train_refiner` composed it holding the IDC and denoiser files'
     tensors bit for bit; the `--remat` run's first loss and gradients
     against the plain run's to phase 8's limits and its steps adding less
     memory; `train_refiner` stopped after epoch 0 and resumed reaching the
     uninterrupted two epochs' step count and learning rate;
     `cli/convergence_demo.py` at its defaults (32 px, narrow widths, every
     stage's epochs), in a process of its own (`--demo-child`) beside the
     phase and joined after 17, with every check of its `check_summary`
     (each stage learns; the trained stack beats a random one by at least 1
     dB) and its launches held to its recorded calls; every map that
     reached `ln_film`, `ln_film_bwd`, the warp or its backward in the phase
     or the demo against the plain version (twice, for equal bits). Printed
     by stage: each step's ms, the median and images/s, the memory a step
     adds, the run's peak and its wall seconds; the demo's summary and wall
     seconds. The demo and, from `train_refiner` on, phase 17's two ranks
     share the card with the phase (and 14), whose times are so for the
     record. Beside the phase's first stages, in a process of its own
     (`--graphs-cli-child`, joined before 17's ranks start), under torch's
     deterministic mode with cuDNN's deterministic algorithms:
     `train_refiner --cuda-graphs` at its default widths, two epochs of 12
     procedural faces at batch 8 (a batch of 8 and a short one of 4 an
     epoch, each shape captured on its first call and replayed in the
     second epoch, after a validation pass), against the same run with
     the step left eager on the same capturable optimizer: every logged
     loss and metric equal;
  14. (run after 13, on the stage files of its `train_vae`, `train_cr` and
     `train_refiner` runs) the perceptual metrics and the distillation CLIs,
     eager, at their default widths, with TF32, the launch counts set to 0
     before and read after: `test_refiner` at its defaults (f32, batch 4)
     with `--vgg16-ckpt --lpips-ckpt --niqe-model` (a VGG16 and lpips heads
     drawn at random under torchvision's and lpips' names, a NIQE model
     fitted on procedural faces): every metric finite, its launches as the
     module tree gives, and one LPIPS call on the card against the host
     CPU's (TF32 off, LPIPS_REL); `train_cr` at its defaults with `--loss
     composite --lambda-vgg 0.1 --vgg19-ckpt` (a random torchvision-named
     VGG19), two steps, through the kernels and through their plain
     versions, and with `--lambda-vgg 0`: the first step's loss and
     gradients against the plain run's, its gradients against the run
     without the term, to phase 8's limits, 9 warp and 9 warp-backward
     launches a step; `train_tae` (batch 64), `train_tiny_cr` (64),
     `train_tiny_dn` (16) and `distill` (16, 50 -> 10 steps, 5 sub-steps),
     two steps each, every step's launches as the module tree gives them
     (`distill_launches`: the teacher's and the student's forwards, the
     student's backward); the distilled student, the tiny denoiser and the
     two tiny seams each through `test_refiner` for one sampler call; every
     map that reached a kernel in the phase against its plain version
     (twice, for equal bits). Printed by stage as in 13;
  15. (run after 17 and the demo, with nothing beside it on the card, on
     phase 13's `train_vae` and `train_cr` directories)
     the PNG data path: a Multi-PIE tree (train and test, 4 pids, 15
     angles, 2 lights, patches on the frontal; 160 x 160) of procedural
     faces written by `png_filtered`, its rows through the five PNG
     filters in turn, and a flat CelebA-HQ directory (968 files, 256 x
     256) in the formats of `celeba_file` in turn (since phase 19: 8-bit
     PNG of colour types 2 and 6, Adam7 PNG, 16-bit RGBA and grey PNG, the
     160 x 160 progressive JPEG fixture, 24-bit and RLE8 BMP, the 160 x
     160 lossy, lossless and animated WebP fixtures and the CMYK JPEG
     fixture), two of the Multi-PIE files replaced by the CMYK JPEG and
     the lossless animated WebP fixtures (read by cv2's rule); the
     decoder's time a file on the host, through
     the host library and plain (160 x 160, 256 x 256 and 640 x 480, the
     filter mix stated); `infer_cr` at its defaults on
     the `train_cr` directory, on the card and on the host CPU (f32, TF32
     off; phase 4's limits), 9 warp launches; `pretrain_idc --dataroot`,
     `pretrain_denoiser --multipie-root --celeba-root` (two steps of 512)
     and `train_tae --multipie-root` (two epochs) at their defaults, every
     step's launches held to the module tree, the loader's wait as a share
     of the steps' wall, the first batch of each pass apart from the rest;
     every map that reached a kernel against its plain version (twice, for
     equal bits). On phase 12's server, one PNG request
     (a 160 x 160 face): 200, the launched batch equal to the port's decode
     and PIL-bicubic resize, its face equal to the eager call on that batch
     with the launch's generator. Phase 13 prints the resize the procedural
     faces' LR protocol uses;
  16. (run after 15, on phase 13's stage files and 15's Multi-PIE tree)
     the JPEG codec slice: the host library (the JPEG codec and the
     data-path core, csrc/host) built with g++ and its log printed; the
     codec against the golden digests of tests/fixtures/jpeg (cv2's and
     PIL's decodes of the files there, cv2.imencode's bytes of seeded
     inputs); a K-Face tree (val 2 ids, test 10, 2 lights, 3 expressions,
     20 angles, 160 x 160, 4:2:0 at quality 95, head boxes past the edge
     on two angles) written by the port's encoder; on the host the decode
     ms a file (160 x 160 and 1920 x 1080), the encode ms, the round trip
     at 16-128 px and the blind branch an item on its default and native
     paths; `infer_cr --dataroot` (one batch of the val split) and
     `--image` on one K-Face JPEG, card vs host CPU to phase 4's limits
     with 9 warp launches a call; `train_cr` (2 steps at batch 8),
     `train_refiner` (2 at 32), `train_tiny_cr`, `train_tiny_dn` and
     `distill` (1 each) with `--dataroot` through the blind branch at their
     defaults, every step's launches held to the module tree, the loader's
     wait as a share of the steps' wall (first batch apart); `test_refiner
     --dataroot` (one
     sampler call on the val split) and `test_idc --dataroot` (2 batches of
     the test split's triplets) with their launches; every map that
     reached a kernel against its plain version (twice, for equal bits);
  17. ((a) after 12, alone on the card; its two ranks started before 13's
     `train_refiner` runs; the rest after 14; before anything is profiled)
     data parallelism over `torch.distributed`, f32 with TF32 off:
     `train_refiner`'s step (batch 32, EMA) and `pretrain_idc`'s (24) at
     full width, two steps each, in a world-1 NCCL group in this process
     against the same steps without a group, bit for bit, and the IDC
     step captured as CUDA graphs (8 rows, its all-reduce in the graph)
     with and without the group, bit for bit; two processes of
     this script (`--dp-child`) on the card over gloo, 16 + 16 and 12 + 12
     rows, against one process on the concatenated batch to the CPU tests'
     limits (the IDC aligned each step, ROADMAP §C2), the ranks' states
     bit-equal after each step, the gradient all-reduce's ms a step, every
     map that reached `ln_film`, `ln_film_bwd` or the warp on either rank
     held to its plain version; `test_refiner` on the two processes against
     one, and `serve --mesh-devices 0` serving on the one card (see the
     constants of phase 17 for why its steps run without cuDNN's
     convolutions);
  18. (run after 16, on phase 15's trees) the host image library
     (csrc/host/image.cc: the PNG row filters, cv2's and PIL's resizes,
     filter2D) on the card's host: its build log (each source's g++ flags
     and seconds), every function against its plain numpy version bit for
     bit over a sweep of shapes, kernels and PNG files (a mismatch fails the
     run), ms a call of each operation at the datasets' shapes through the
     library and plain, and items a second of the Multi-PIE (blind branch
     and not), Multi-PIE HQ, CelebA-HQ and K-Face crop datasets through
     the Loader with 4 threads and with 1, one item of each first with the
     library's calls counted and the plain versions made to fail (a
     dataset that does not reach the library fails the run);
  19. (run after 18, on phase 13's `train_cr` directory) the image
     formats the decoders gained (progressive JPEG, Adam7-interlaced and
     16-bit PNG, BMP, WebP, animated WebP, CMYK, YCCK and RGB-coded JPEG)
     and the cv2 sites' EXIF orientation on the card's host, which has
     neither PIL nor cv2: the four-component JPEG fixtures decoded by each
     reader to their digests (PIL's and cv2's, which differ), their
     coefficients equal to the plain decoder's and their RGB to the plain
     colour steps on the library's components; the files of
     tests/fixtures/png and tests/fixtures/bmp decoded by the host library
     and by the plain versions to their golden digests (PIL's and cv2's
     decodes, with `reader` naming the library), the refused ones refused,
     and the coefficients of every progressive JPEG fixture (phase 16
     holds their RGB to tests/fixtures/jpeg) equal to the plain decoder's;
     the files of tests/fixtures/webp (lossy and lossless, extended, the
     frames of `vp8_frame`) to theirs, the lossless ones by the plain
     decoder too, the lossy ones' coefficients equal to the plain parse's,
     each ALPH chunk's alpha (the library's and the plain version's) to
     PIL's, the animations' first frames to theirs, the refused ones
     (truncated, a canvas of another size, a lossless stream cut short, an
     alpha stream cut short, a frame past its canvas) refused; the 24
     files of
     tests/fixtures/orientation (PNG, JPEG and WebP at orientations 1-8)
     read as cv2.imread and as PIL read them; the host library against its
     plain versions on PNG files of every colour type, depth and interlace
     and BMP files of every layout written here, the two JPEG colour steps
     on all 65,536 (C, K) pairs and the alpha unfilters on raw ALPH
     payloads (a mismatch fails the run); the host ms a file, library and
     plain, of the 160 x 160 and 1920 x 1080 progressive fixtures, of a
     160 x 160 Adam7 PNG, 16-bit PNG and BMP, of the 160 x 160 CMYK
     fixture, and of the 160 x 160 and 1024 x 1024 WebP fixtures, lossless
     and lossy, and the 160 x 160 animations; `infer_cr --image` on a
     progressive JPEG, a BMP, a lossy WebP, an animated WebP and a CMYK
     JPEG, card vs host CPU to phase 4's limits with 9 warp launches a
     call. On phase 12's server, an Adam7 16-bit RGB PNG body, a 16-bit
     grey one, a lossy WebP, an animated WebP and a CMYK JPEG (the
     launched batch equal to the port's decode, as PIL reads them, and
     PIL-bicubic resize; the face equal to the eager call); phase 15's
     `pretrain_denoiser --celeba-root` reads the mixed CelebA-HQ files,
     WebP, animated WebP and CMYK JPEG among them;
  20. (in the demo's process, after the demo, on its stage files, beside
     phases 13, 14 and 17: its wall seconds are for the record) the
     quality scripts of hifidiff_tpu_torch/scripts/, f32 with TF32 off:
     (a) `cache_quality` at its defaults on the card; (b) its exact and
     interval-2 rows again on the host CPU on the same weights and draws,
     to phase 4's limits on the final latents and the faces and within
     QUALITY_PSNR_TOL in their PSNRs, the card's interval-2 row against
     the host's exact one a control that must fail; (c) the other six
     scripts at cut lengths, chained through a work directory
     (`QUALITY_SCRIPTS`). Every figure finite, every record's keys those
     of the committed default run's record; each script's rows, wall
     seconds and launches printed; the launches held with the demo's to
     the recorded calls at the join;
  7. (run after 3) the two backward kernels, `ln_film_bwd` and
     `affine_warp_bwd`, against their plain PyTorch versions on the card at
     every shape of the training paths: the five refiner shapes at batch 32
     with a per-sample FiLM and with a (1, C) FiLM, f32 and bf16 maps, with
     and without dw and db (a frozen block wants none), each call also twice
     for equal bits; the CR's nine STN maps at batch 8 with identity,
     random, shear and out-of-bounds thetas, each call also twice for equal
     bits, and dx alone and dcoef alone; with both versions' times, each shape's bound and, for the warp, the
     library's `grid_sampler_2d_backward`; `ln_film_bwd` timed on copies of
     x and g beyond L2, beside `torch.autograd.grad` of phase 3's library
     route;
  8. (run after 5) one CR train step and one refiner train step at full
     width, f32 with TF32 off, batch 4, on the same seeded weights, inputs
     and noise: on the card through the kernels and on the host CPU through
     the plain versions. Compared: the loss, the gradient of every trainable
     parameter, and the parameters and BatchNorm statistics after two
     further steps. Two controls must fail the same limits: dcoef zeroed in
     the CR step; dscale and dshift zeroed in the refiner step. The same
     three card steps on the capturable optimizer a captured step runs
     (`optim.adam` / `adamw_cosine(capturable=True)`, the rate a device
     tensor) against the same host run, to the same limits. Then the
     captured steps (`train/graphs.py`), under torch's deterministic mode
     with cuDNN's deterministic algorithms: the refiner step at batch 32
     and the CR step at batch 8, the first call (the state's step, which
     warms up and captures) and three replays each against four eager
     steps of a copy of the state on the same capturable optimizer, batches
     and draws, every metric and state tensor (parameters, buffers,
     gradients, optimizer state) equal, the first call's launches twice the
     module tree's step and none from Python in a replay; a control, the
     refiner's replay after the rate's write was skipped, must differ;
  9. (run after 19, the last timing of the run) timed train steps on the
     card in f32 with TF32 (the steps compute in
     the module's dtype): refiner steps at batch 32 and CR steps at batch 8.
     After a warm-up step, one step with the launch counts set to 0 before
     and read after, in which the shapes reaching every kernel wrapper are
     recorded: the counts are held to the module tree and to the recorded
     calls, and every recorded shape must have been compared and timed in
     phases 3 and 7. Then the step captured as CUDA graphs on a second
     state (its first call, the warm-up and the capture, launching twice
     the tree's step), and eager steps and replays timed in turns (images/s
     as the median and the spread of each, the eager step's peak memory,
     what the captured state and its graph pool reserve; no launch from
     Python in a replay), and the host's ms of the capture's state-key
     check before each replay; (at the end of the run) one eager step under
     `torch.profiler` for the share of the step in which the card is busy,
     one more with the host's operators traced, for the device launches
     (kernels and memsets) of each backward kernel's call (`ln_film_bwd` in
     the refiner step, at most two; `affine_warp_bwd` in the CR step, at
     most three), and one replay of the timed capture for its busy share;
     then the other eight train steps (IDC, denoiser, cached denoiser under
     `remat`, VAE, progressive distillation, tiny denoiser, tiny CR, tiny
     autoencoder; two with accumulation and an EMA) at batch 2 and at their
     default widths and depths, each captured and three replays held to
     eager steps as in 8, with a finite loss and a parameter that moved.

Whatever runs under `torch.profiler` runs after every timing of the run is
taken: no timed launch follows a profiler trace in the same process. A map
that reached a kernel in phases 13-19 is held to its plain version by the
first phase that recorded it (`HELD_MAPS`); a later one counts it as held.

The line before the last is a JSON object with one entry per kernel (times
are sums over the launches of one call of the kernel's path: `ln_film` and
the warp on the sampler's default path (their `server_launches`: the
server's, all in its warm-up), `matmul_w8`, `group_norm_silu` and
the fused block on its int8 + fused path, `ln_film_bwd` on a refiner train
step and `affine_warp_bwd` on a CR train step; under "paths" the same sums
for every path that launched the kernel, the train steps included; under
"phase14_launches_per_step" and "phase16_launches_per_step" a step's
launches in each of phase 14's and phase 16's training stages that
launched it, under "phase17_launches_per_step_a_rank" a step's launches on
one of phase 17's two ranks, under "phase20_launches_by_script" each
quality script's launches in phase 20); the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from hifidiff_tpu_torch.data.image_files import (CELEBA_CMYK,
                                                 CELEBA_PROGRESSIVE,
                                                 CELEBA_WEBP,
                                                 bmp_file, celeba_file,
                                                 golden_input, png_file,
                                                 png_filtered)

SEED = 0
BATCH = 128
STEPS = 50
# cut from 10 and 5 (and phase 10's depth, phase 12's requests) in PR 13 to
# keep the whole script, phase 17 added, inside its time limit on slower
# hosts; from 6 and 4 (with phase 11's replays and phase 12's requests) to
# pay for phase 19 (8 s) and phase 12's two more requests: on a slow host
# the script ran 1167 s of its 1200 with them
TIMED_CALLS = 5          # the default path
TIMED_CALLS_INT8 = 3     # each int8 configuration

KERNELS = {
    "ln_film": ("hifidiff_tpu_torch/csrc/ln_film.cu",
                "hifidiff_tpu/ops/pallas/ln_film.py:113"),
    "affine_warp": ("hifidiff_tpu_torch/csrc/warp.cu",
                    "hifidiff_tpu/ops/pallas/warp.py:118"),
    "matmul_w8": ("hifidiff_tpu_torch/csrc/matmul_w8.cu",
                  "hifidiff_tpu/ops/pallas/int8_matmul.py:55"),
    "group_norm_silu": ("hifidiff_tpu_torch/csrc/gn_silu.cu",
                        "hifidiff_tpu/ops/pallas/groupnorm_silu.py:90"),
    "cnaf_small": ("hifidiff_tpu_torch/csrc/cnaf_small.cu",
                   "hifidiff_tpu/ops/pallas/naf_block.py:226"),
    "ln_film_bwd": ("hifidiff_tpu_torch/csrc/ln_film_bwd.cu",
                    "hifidiff_tpu/ops/pallas/ln_film.py:139"),
    # the TPU takes jax.vjp of the gather form here, no pallas_call
    "affine_warp_bwd": ("hifidiff_tpu_torch/csrc/warp_bwd.cu",
                        "hifidiff_tpu/ops/warp.py:225"),
}

# default-path shapes: (C, H, W) -> launches per denoiser step (ln_film: two
# per ConditionalNAFBlock; enc 16^2x128 x2, 8^2x256 x2, 4^2x512 x4,
# 2^2x1024 x8, mid 1^2x2048 x8, dec 2^2x1024, 4^2x512, 8^2x256, 16^2x128
# x2 each) and per CR call (the warp: one per STN). Phase 6 holds the
# recorded shapes against these tables.
LN_FILM_SHAPES = {(128, 16, 16): 8, (256, 8, 8): 8, (512, 4, 4): 12,
                  (1024, 2, 2): 20, (2048, 1, 1): 16}
WARP_SHAPES = {(32, 128, 128): 1, (64, 64, 64): 2, (128, 32, 32): 2,
               (256, 16, 16): 2, (512, 8, 8): 2}
# the fused block's two shapes: (C, map side) -> blocks per step at 16x16
# latents (mid; enc3 + dec0)
LATENT = 16
FUSED_SHAPES = {(2048, 1): 8, (1024, 2): 10}
# the warp's thetas: a base matrix and the spread of the noise added per
# sample
IDENTITY = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
THETAS = {"identity": (IDENTITY, 0.0), "random": (IDENTITY, 0.05),
          "shear": ([[1.0, 0.3, 0.1], [0.4, 0.9, -0.2]], 0.02),
          "zoom_in": ([[0.5, 0.0, 0.1], [0.0, 0.5, -0.1]], 0.02),
          "out_of_bounds": ([[1.7, 0.2, 1.5], [-0.3, 2.0, -1.9]], 0.02)}

# kernel vs plain on the same inputs. f32: ln_film and GroupNorm sum in
# another order (a few ulps); the warp rounds each op in the plain version's
# order. bf16: both round one float32 value; a changed sum order can move it
# one bf16 ulp (2^-8 relative).
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-2)}
# matmul_w8 and the fused block: float32 sums over K <= 2048 in another
# order than the plain version, then one rounding to bf16: one bf16 ulp
# (2^-8 relative) of outputs of order 1-4, plus an absolute term where a sum
# cancels. The block chains five products, so an ulp of an intermediate
# moves the output by a few ulps.
GEMM_TOL = (2 ** -7, 2e-2)
BLOCK_TOL = (2 ** -6, 6e-2)
# BLOCK_TOL alone would pass a block that does nothing: a block's output is
# its input plus two branches, and on the seeded weights both branches lie
# near one bf16 ulp of the input, the first a thousandth of the second. So
# the checks of the fused block run on blocks scaled by
# `random_weights.amplify_naf_blocks_` (each branch a tenth of the input or
# more) and compare what the block adds, (out - x) against (plain - x), as
# the norm of the difference over the norm of (plain - x). Kernel and plain
# version round to bf16 at the same places, so they differ only where a
# float32 value lies on a rounding boundary. Controls that leave out a part
# of the block (the off-centre taps of the position mix, the SCA gate, the
# second branch) must fail the limit.
BRANCH_TOL = 2e-2
# group_norm_silu on a near-constant group with a large mean: the plain
# version (F.group_norm) computes x * a + b with a = rstd * w of about 1e3,
# which loses about 50 * 1e3 * 2^-24 = 3e-3 to cancellation; the kernel
# subtracts the mean first. The JAX package bounds the same case by 2e-2.
NEAR_CONSTANT_TOL = (1e-2, 2e-2)
# Phase 4: f32 end to end, card vs host CPU, TF32 off on the card. The sums
# of convs and matmuls differ in order across ~300 layers and 50 steps: the
# final latents agree to about 1e-6 of their scale and the faces to 1 level
# (one rounding boundary). Two controls must fail these limits: the card
# run in bf16, and the card run with the FiLM of every block left out.
LATENT_REL_TOL = 1e-5
FACE_LEVEL_TOL = 1
# Phase 5: the int8 weights are the same bytes on both sides, so what
# separates the card's bf16 run from the host's float32 run, and from the
# same bf16 run through the three plain versions, is bf16 rounding carried
# through 50 steps: phase 4's bf16 control reads 3.4e-3 of the latents'
# scale and 3 levels, and the limits leave that noise a factor of two. That
# noise hides what a fused block does (a run whose position mix is cut to
# its centre tap reads the same), so every fused block of the first step is
# also held to its plain version on the very input and FiLM row the run gave
# it, on what it adds to that input, as in phase 3 (BRANCH_TOL); for that the
# blocks that fuse are amplified as in phase 3, and only they, so that the
# rest of the model keeps the default path's weights and its bf16 noise.
INT8_LIMITS = (7e-3, 6)
# Phase 10: the new paths at full width, batch 2, f32 with TF32 off, card vs
# host CPU, NEW_PATH_STEPS steps each: the limits of phase 4 (LATENT_REL_TOL,
# FACE_LEVEL_TOL) on the final latents and the uint8 faces; the
# unconditional sampler's float faces to UNCOND_TOL (phase 4's latents
# agree to 1e-6 of their scale, and the decoder keeps that: a fortieth of a
# uint8 level). Each path has a control that must fail its limits: a card
# run that leaves out what the path adds (the path's option ignored: the
# exact DDIM run; for the paths whose math equals the exact one's, the FiLM
# left out).
NEW_PATH_STEPS = 4
UNCOND_TOL = 1e-4
# The graphs (phase 6): a replay's scan must take at most this many times
# the card's own time in it (the kernels' sum under torch.profiler).
GRAPH_SCAN_RATIO = 1.05
# Phase 11: timed under graphs, default configuration, batch 128.
GRAPH_SAMPLERS = {"dpmpp, 20 steps": dict(sampler="dpmpp",
                                          num_inference_steps=20),
                  "cached DDIM-50, interval 2": dict(cache_interval=2),
                  "cached DDIM-50, interval 3": dict(cache_interval=3)}
TIMED_REPLAYS = 4        # 5 before phase 19 (see TIMED_CALLS)
# Phase 12: the server at its defaults (batch 16, bf16, exact DDIM-50, clip
# 3.0) with buckets 1 and 4; the load generator's concurrencies and requests
# per client; the requests at concurrency 1 held to eager calls; the calls
# timed for the host's share of a launch. The eval CLI (`test_refiner`, at
# its defaults: f32, batch 4, float I/O) on the same weight files over the
# held-out split of this many procedural faces (a quarter of it: 2 batches).
SERVE_BUCKETS = "1,4"
SERVE_CONCURRENCIES = (1, 4, 16, 32)
SERVE_REQUESTS = 6       # 8 before phase 19 (see TIMED_CALLS)
SERVE_EAGER_CHECKS = 3
SERVE_TIMED = 10
EVAL_PROCEDURAL = 32
EVAL_BATCHES = 2

# Training (phases 7-9). The CLIs' default batches, and the check's batch.
REFINER_BATCH, CR_BATCH, CHECK_BATCH = 32, 8, 4
# phase 13: each training CLI on `--procedural` this many of its batches
STAGE_BATCHES = 2
# phase 13's convergence demo runs in a process of its own beside the
# training CLIs (96 s alone on an H100); the seconds it may take
DEMO_TIMEOUT = 900
# phase 14: the faces the NIQE model is fitted on, LPIPS card vs host CPU,
# and distill's procedural faces (its held-out quarter is one eval batch)
NIQE_FACES = 48
LPIPS_REL = 1e-4
DISTILL_PROCEDURAL = 64
TIMED_STEPS = 8
CAPTURE_STEPS = 3        # replays held to eager steps, per captured step
KEY_CHECKS = 20          # timed checks of a capture's state key
OTHER_CAPTURE_BATCH = 2
TINY_DN_WIDTH = 64       # train_tiny_dn's default --tiny-width
THETAS_BWD = {k: THETAS[k]
              for k in ("identity", "random", "shear", "out_of_bounds")}
# Backward kernel vs plain, as the largest difference over the tensor's
# largest value. f32: sums over up to 2048 channels or 16384 pixels of
# order-1 terms in another order (fixed run to run, but not the plain
# version's). bf16 dx: one rounding of a float32 value (2^-8),
# and the cancellation in `gw - y * mean - mean`. The sums stay float32.
# dcoef sums C*H*W terms times pixel coordinates up to 127.
BWD_REL = {"float32": 2e-5, "bfloat16": 2 ** -6}
SUM_REL = 2e-5
DCOEF_REL = 1e-4
# Phase 8: f32 with TF32 off, card (kernels) vs host CPU (plain versions).
# The loss passes some 300 layers whose sums differ in order. A parameter's
# gradient is compared as |g_card - g_cpu| / max(|g_cpu|, floor) in the
# 2-norm, the floor being a thousandth of the largest gradient norm of the
# model (a bias in front of a BatchNorm has a true gradient of zero and
# holds rounding noise only). After three Adam steps: Adam's first updates
# are sign-like, so an entry whose gradient is rounding noise may move the
# other way; at most 3e-3 of the trained entries may differ by more than a
# twentieth of a learning rate per step (readings: 2.3e-4 of the CR's,
# 1.1e-3 of the refiner's), none by more than 1.5 learning rates per step
# (readings 0.69 and 1.11; two opposite full steps would read 2);
# BatchNorm statistics, which follow the parameters, to 1e-3 of the tensor's
# largest value (reading: 3.6e-4). The controls (a backward with dcoef, or
# dscale and dshift, zeroed) must fail these limits on the first step's
# gradients.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-2
TRAIN_GRAD_FLOOR = 1e-3
TRAIN_PARAM_LR = 5e-2
TRAIN_PARAM_SHARE = 3e-3
TRAIN_PARAM_FAR = 1.5
TRAIN_STATS_REL = 1e-3

# the card's published peaks (H100 SXM): device memory bytes/s, and
# operations/s for bf16 tensor-core products and for plain float32 math
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_mma": 989e12, "f32": 67e12}

FAILURES = []
# (kernel, map) pairs `check_recorded_shapes` has held to the plain version
HELD_MAPS = set()


def log(*a):
    print(*a, flush=True)


def fail(what):
    log(f"FAILED: {what}")
    FAILURES.append(what)


@contextlib.contextmanager
def patched(module, name, value):
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield original
    finally:
        setattr(module, name, original)


def time_ms(fn, iters=20, warmup=3):
    """(eager, graph) ms per call. `fn` is one function or a list that is
    walked in turn (copies of the weights at other addresses, so that no
    call finds its weights in L2). Eager: `iters` calls from Python between
    two CUDA events, which includes the host's enqueue time when that is
    the longer. Graph: the same calls captured once in a CUDA graph and
    replayed, the card's own time."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    calls = [fns[i % len(fns)] for i in range(max(iters, len(fns)))]
    for f in calls[:max(warmup, len(fns))]:
        f()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for f in calls:
        f()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / len(calls)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return eager, start.elapsed_time(end) / len(calls)


def l2_copies(*tensors):
    """The tensors and copies of them at other addresses, as many sets as
    make a walk over them read 100 MB (twice the 50 MB L2) before a set is
    read again, at most 256: what time_ms walks so that no call finds its
    inputs in L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = min(256, max(1, math.ceil(100e6 / nbytes)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def ln_film_route(x, w, b, scale, shift, eps=1e-6):
    """The nearest library route to `ln_film` (a yardstick; the port never
    calls it): `F.layer_norm` over a channels-last view of the NCHW map, then
    the FiLM's multiply-add, returned as an NCHW view."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), w, b, eps)
    return (y * (1.0 + scale[:, None, None, :])
            + shift[:, None, None, :]).permute(0, 3, 1, 2)


def ln_film_route_bwd(g, x, w, b, scale, shift, eps=1e-6):
    """The backward of the same route: `torch.autograd.grad` of
    `ln_film_route` for (dx, dw, db, dscale, dshift). The inputs are leaves
    that require a gradient."""
    return torch.autograd.grad(ln_film_route(x, w, b, scale, shift, eps),
                               (x, w, b, scale, shift), g)


def bound_ms(nbytes, ops, rate):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move `nbytes` through device memory once or to do `ops` operations at
    the peak rate of their type, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[rate] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def close(out, ref, tol):
    rtol, atol = TOL[tol] if isinstance(tol, str) else tol
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out).all()) and \
        bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


class Stats:
    """Per kernel: the worst |kernel - plain| of every comparison, and per
    shape the per-launch times on the card (CUDA graph replay) beside the
    shape's bound: under (C, H, W) the samplers' bf16 maps at batch 128,
    under (dtype, B, C, H, W) the train steps' maps."""

    def __init__(self):
        self.err = collections.defaultdict(float)
        self.shapes = collections.defaultdict(dict)

    def compare(self, name, label, out, ref, tol):
        ok, err = close(out, ref, tol)
        self.err[name] = max(self.err[name], err)
        log(f"{name} {label}: max_abs_err={err:.3e} ok={ok}")
        if not ok:
            fail(f"{name} {label}: kernel and plain version disagree")
        return ok

    def compare_rel(self, name, label, outs, refs, limits):
        """Each of `outs` against its `refs` entry: the largest difference
        over the reference's largest value, held to its `limits` entry."""
        worst, ok = [], True
        for out, ref, limit in zip(outs, refs, limits):
            diff = float((out.float() - ref.float()).abs().max())
            rel = diff / max(float(ref.float().abs().max()), 1e-30)
            self.err[name] = max(self.err[name], diff)
            worst.append(rel)
            ok = ok and bool(torch.isfinite(out).all()) and rel <= limit
        log(f"{name} {label}: rel_err=" + ", ".join(f"{r:.2e}" for r in worst)
            + f" ok={ok}")
        if not ok:
            fail(f"{name} {label}: kernel and plain version disagree")
        return ok

    def measure(self, name, key, label, kernel, plain, nbytes, ops, rate,
                library=None, keep=True, iters=20):
        with torch.inference_mode():
            k = time_ms(kernel, iters)
            p = time_ms(plain, iters)
            lib = time_ms(library, iters) if library is not None else None
        b, by = bound_ms(nbytes, ops, rate)
        log(f"{name} {label}: kernel {k[1]:.4f} ms, plain {p[1]:.4f} ms"
            + (f", library {lib[1]:.4f} ms" if lib else "")
            + f" per launch on the card; bound {b:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop); eager from "
            f"Python {k[0]:.4f} / {p[0]:.4f} ms")
        if keep:
            self.shapes[name][key] = dict(
                ms=k[1], plain_ms=p[1], bound_ms=b, bound_by=by,
                library_ms=lib[1] if lib else None)

    def totals(self, name, by_shape):
        """Sums over the launches `by_shape` ({shape: count}) of one sampler
        call, or None where a shape was not timed."""
        rows = self.shapes[name]
        if not by_shape or any(k not in rows for k in by_shape):
            return None

        def total(field):
            vals = [rows[k].get(field) for k in by_shape]
            if any(v is None for v in vals):
                return None
            return sum(n * v for n, v in zip(by_shape.values(), vals))

        by = collections.Counter()
        for k, n in by_shape.items():
            by[rows[k]["bound_by"]] += n * rows[k]["bound_ms"]
        return {"launches": sum(by_shape.values()), "ms": total("ms"),
                "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                "bound_by": by.most_common(1)[0][0],
                "library_ms": total("library_ms"),
                "pair_ms": total("pair_ms"),
                "route_ms": total("route_ms"),
                "cublas_bf16_ms": total("cublas_bf16_ms")}

    def entry(self, name, path, launches, shapes):
        """One kernel's entry of the result line: the sums over one sampler
        call of `path`, and under "paths" the same sums for every path that
        launched the kernel. launches: {path: {kernel: count}}, shapes:
        {path: {kernel: {shape: count}}}."""
        paths = {p: self.totals(name, shapes[p][name]) for p in shapes
                 if launches[p][name]}
        for p, t in paths.items():
            if t is None or t["launches"] != launches[p][name]:
                fail(f"{name}: the shapes {dict(shapes[p][name])} of the "
                     f"{p} path were not all compared and timed")
        main = paths.get(path)
        if main is None or None in paths.values():
            return None
        source, replaces = KERNELS[name]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[path][name],
               "max_abs_err": self.err[name],
               **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
               "path": path, "paths": paths}
        if main["pair_ms"] is not None:
            # no single PyTorch call computes it: the nearest library route
            out["bf16_pair_ms"] = main["pair_ms"]
        if main["route_ms"] is not None:
            # F.layer_norm and the FiLM's multiply-add (forward), or its
            # autograd (backward): the nearest library route
            out["layer_norm_route_ms"] = main["route_ms"]
        if main["cublas_bf16_ms"] is not None:
            # torch.matmul on bf16 weights: not the same function
            out["cublas_bf16_ms"] = main["cublas_bf16_ms"]
        return out


def report_build(build_log):
    """Print what `-Xptxas -v` says of every kernel (registers, static shared
    memory, spills); a spill in a kernel of the GEMM tile fails the run, and
    so does the assembler's notice that it made the `wgmma`s of a stage wait
    for one another."""
    entry = ""
    for line in build_log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line)
        if "wgmma.mma_async instructions are serialized" in line:
            fail(f"the assembler serialized the tile's MMAs: {line}")
        if "spill" in line and "gemm_kernel" in entry \
                and "0 bytes spill stores, 0 bytes spill loads" not in line:
            fail(f"the GEMM tile spills registers in {entry}: {line}")


def chain_split(calls, chain, repeats):
    """The time each kernel of a chain of dependent launches adds, in us:
    how long it runs after the kernel before it has ended (under
    programmatic dependent launch a kernel starts while the one before it
    drains), as the median over the calls of `calls` walked `repeats` times
    under `torch.profiler`. `chain` names the kernel of each launch of one
    call, in order. Returns (times, chains seen); the profiler may drop
    events at the ends of a trace, so only whole chains are read, and
    the times are None where it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for f in calls:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            for f in calls:
                f()
        torch.cuda.synchronize()
    kinds = sorted(set(chain))
    spans = sorted((e.time_range.start, e.time_range.end, kind)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   for kind in kinds if kind in e.name)
    added, seen, i = [[] for _ in chain], 0, 0
    while i + len(chain) <= len(spans):
        if any(spans[i + j][2] != kind for j, kind in enumerate(chain)):
            i += 1
            continue
        for j in range(len(chain)):
            start, end, _ = spans[i + j]
            added[j].append(end - max(start, spans[i + j - 1][1] if j else
                                      start))
        seen, i = seen + 1, i + len(chain)
    return ([statistics.median(v) for v in added] if seen else None), seen


def dtype_name(dtype):
    return str(dtype).split(".")[1]


def same_bits(name, label, fn):
    """Call `fn` twice on the same inputs; fail unless every output of the
    two calls is equal bit for bit."""
    with torch.inference_mode():
        one, two = fn(), fn()
    if isinstance(one, torch.Tensor):
        one, two = (one,), (two,)
    if not all(u is v or torch.equal(u, v) for u, v in zip(one, two)):
        fail(f"{name} {label}: two runs on the same inputs differ")


def time_ln_film(stats, key, label, x, w, b, scale, shift, keep=True):
    """`ln_film`, its plain version and the library route timed on copies of
    x beyond L2. Bound: one read and one write of the map, the two (C,)
    rows and the FiLM's rows; about ten float32 operations per element."""
    from hifidiff_tpu_torch.ops import norm

    xs = [xc for xc, in l2_copies(x)]
    iters = max(20, len(xs))
    stats.measure(
        "ln_film", key, label,
        [lambda xc=xc: norm.ln_film(xc, w, b, scale, shift) for xc in xs],
        [lambda xc=xc: norm.ln_film_plain(xc, w, b, scale, shift)
         for xc in xs],
        (2 * x.numel() + 2 * w.numel() + 2 * scale.numel())
        * x.element_size(), 10 * x.numel(), "f32", keep=keep, iters=iters)
    with torch.inference_mode():
        route = time_ms([lambda xc=xc: ln_film_route(xc, w, b, scale, shift)
                         for xc in xs], iters)[1]
        stream = time_ms([lambda xc=xc: xc.mul(1.5) for xc in xs], iters)[1]
    log(f"ln_film {label}: layer_norm_route_ms {route:.4f} (F.layer_norm "
        "over a channels-last view and the FiLM's multiply-add; a "
        f"yardstick the port does not call); x.mul(1.5) {stream:.4f} ms "
        "(one streaming pass over the map's bytes)")
    if keep:
        stats.shapes["ln_film"][key]["route_ms"] = route


def check_ln_film(dev, g, stats):
    """`ln_film` against its plain version, twice for equal bits, and timed
    (`time_ln_film`): at the samplers' batch with a shared and a per-sample
    FiLM (the bf16 times are the default path's), and at the refiner step's
    batch with per-sample FiLM rows 4C apart."""
    from hifidiff_tpu_torch.ops import norm

    for dtype in (torch.bfloat16, torch.float32):
        dn = dtype_name(dtype)
        for c, h, w in LN_FILM_SHAPES:
            x = torch.randn(BATCH, c, h, w, generator=g, device=dev).to(dtype)
            wt, bs = (torch.randn(c, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            for fb in (1, BATCH):  # the path's shared film, and per-sample
                s, t = (0.1 * torch.randn(fb, c, generator=g, device=dev)
                        .to(dtype) for _ in range(2))
                label = f"{dn} {BATCH}x{c}x{h}x{w} film_batch={fb}"
                with torch.inference_mode():
                    stats.compare(
                        "ln_film", label, norm.ln_film(x, wt, bs, s, t),
                        norm.ln_film_plain(x, wt, bs, s, t), dn)
                same_bits("ln_film", label,
                          lambda: norm.ln_film(x, wt, bs, s, t))
            time_ln_film(stats, (c, h, w), f"{dn} {BATCH}x{c}x{h}x{w}", x,
                         wt, bs, s[:1], t[:1], keep=dtype == torch.bfloat16)
            del x
    # a train step's calls: per-sample FiLM rows 4C apart with unit channel
    # stride, as a block's `film.chunk(4, dim=1)` gives them, batch 32
    b = REFINER_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        for c, h, w in LN_FILM_SHAPES:
            x = torch.randn(b, c, h, w, generator=g, device=dev).to(dtype)
            wt, bs = (torch.randn(c, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            film = (0.3 * torch.randn(b, 4 * c, generator=g,
                                      device=dev)).to(dtype)
            shift, scale = film.chunk(4, dim=1)[:2]
            label = f"{dn} {b}x{c}x{h}x{w}"
            with torch.inference_mode():
                stats.compare(
                    "ln_film", f"{label} film rows 4C apart",
                    norm.ln_film(x, wt, bs, scale, shift),
                    norm.ln_film_plain(x, wt, bs, scale, shift), dn)
            same_bits("ln_film", f"{label} film rows 4C apart",
                      lambda: norm.ln_film(x, wt, bs, scale, shift))
            time_ln_film(stats, (dn, b, c, h, w), label, x, wt, bs, scale,
                         shift)
    torch.cuda.empty_cache()


def check_warp(dev, g, stats):
    """The warp at the samplers' batch (bf16 and f32; the bf16 times are
    kept under (C, H, W)) and at the train steps' batches, 8 for the CR
    under training and 32 for the refiner step's frozen CR (kept under
    (dtype, B, C, H, W))."""
    from hifidiff_tpu_torch.ops import warp

    for b in (BATCH, CR_BATCH, REFINER_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            for c, h, w in WARP_SHAPES:
                check_warp_shape(dev, g, stats, warp, dtype, (b, c, h, w))


def check_warp_shape(dev, g, stats, warp, dtype, shape):
    """Every theta against the plain version (f32 bit for bit: the kernel
    rounds each product and sum in the plain version's order) and twice
    for equal bits; timed at the random theta on copies of the map beyond
    L2, beside the library's `F.affine_grid` + `F.grid_sample`."""
    b, c, h, w = shape
    dn = dtype_name(dtype)
    label = f"{dn} {b}x{c}x{h}x{w}"
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    for kind, (base, spread) in THETAS.items():
        theta = torch.tensor(base, device=dev) + spread * torch.randn(
            b, 2, 3, generator=g, device=dev)
        coef = warp.pixel_coef(theta, h, w)
        with torch.inference_mode():
            out = warp.warp(x, coef)
            ref = warp.warp_plain(x, coef)
            ok = stats.compare("affine_warp", f"{label} {kind}", out, ref, dn)
        if ok and dtype == torch.float32 and not torch.equal(out, ref):
            fail(f"affine_warp {label} {kind}: float32 not bit-equal to the "
                 "plain version")
        same_bits("affine_warp", f"{label} {kind}",
                  lambda: warp.warp(x, coef))
        zeros = int((out == 0).sum())
        if ok and kind == "out_of_bounds" and zeros == 0:
            fail(f"affine_warp {label}: no zero padding")
        if kind != "random":
            continue
        xs = [xc for xc, in l2_copies(x)]

        def library(xc):
            # the library's route: a normalised grid in x's dtype
            grid = F.affine_grid(theta, list(x.shape),
                                 align_corners=False).to(dtype)
            return F.grid_sample(xc, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)

        # one read and one write of the map and the coefficients; about a
        # dozen float32 operations per output element
        sampler = b == BATCH
        stats.measure(
            "affine_warp", (c, h, w) if sampler else (dn, b, c, h, w), label,
            [lambda xc=xc: warp.warp(xc, coef) for xc in xs],
            [lambda xc=xc: warp.warp_plain(xc, coef) for xc in xs],
            2 * x.numel() * x.element_size() + coef.numel() * 4,
            12 * x.numel(), "f32",
            library=[lambda xc=xc: library(xc) for xc in xs],
            keep=not sampler or dtype == torch.bfloat16,
            iters=max(20, len(xs)))
        del xs


def check_ln_film_bwd(dev, g, stats):
    """`ln_film_bwd` at the refiner step's shapes, batch 32: f32 and bf16
    maps with tables of their dtype, FiLM rows per sample (4C apart, as
    `film.chunk(4, dim=1)` gives them) and shared (1, C), with and without
    dw and db; each call also twice for equal bits. Timed on copies of x
    and g beyond L2, beside the library route's autograd."""
    from hifidiff_tpu_torch.ops import norm

    b = REFINER_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        limits = [BWD_REL[dn]] + [SUM_REL] * 4
        for c, h, w in LN_FILM_SHAPES:
            x, gr = (torch.randn(b, c, h, w, generator=g, device=dev)
                     .to(dtype) for _ in range(2))
            wt, bs = (torch.randn(c, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            for fb in (b, 1):
                film = (0.3 * torch.randn(fb, 4 * c, generator=g,
                                          device=dev)).to(dtype)
                scale = film.chunk(4, dim=1)[1]
                label = f"{dn} {b}x{c}x{h}x{w} film_batch={fb}"
                stats.compare_rel(
                    "ln_film_bwd", label,
                    norm.ln_film_bwd(gr, x, wt, bs, scale),
                    norm.ln_film_bwd_plain(gr, x, wt, bs, scale), limits)
                same_bits("ln_film_bwd", label,
                          lambda: norm.ln_film_bwd(gr, x, wt, bs, scale))
                # a frozen block under a trainable time MLP: no dw, db
                got = norm.ln_film_bwd(gr, x, wt, bs, scale, need_wb=False)
                ref = norm.ln_film_bwd_plain(gr, x, wt, bs, scale,
                                             need_wb=False)
                if got[1] is not None or got[2] is not None:
                    fail(f"ln_film_bwd {dn} {c}x{h}x{w}: dw, db without "
                         "need_wb")
                stats.compare_rel(
                    "ln_film_bwd", f"{label} without dw, db",
                    (got[0], *got[3:]), (ref[0], *ref[3:]),
                    [limits[0], SUM_REL, SUM_REL])
                same_bits("ln_film_bwd", f"{label} without dw, db",
                          lambda: norm.ln_film_bwd(gr, x, wt, bs, scale,
                                                   need_wb=False))
            scale = (0.3 * torch.randn(b, 4 * c, generator=g, device=dev)
                     ).to(dtype).chunk(4, dim=1)[1]
            copies = l2_copies(gr, x)
            iters = max(20, len(copies))
            # x and g read, dx written, the three tables read, dw and db
            # written as float32 (C,) sums and dscale and dshift as float32
            # rows of scale's shape; about 30 float32 operations per element
            stats.measure(
                "ln_film_bwd", (dn, b, c, h, w), f"{dn} {b}x{c}x{h}x{w}",
                [lambda gc=gc, xc=xc: norm.ln_film_bwd(gc, xc, wt, bs, scale)
                 for gc, xc in copies],
                [lambda gc=gc, xc=xc: norm.ln_film_bwd_plain(gc, xc, wt, bs,
                                                             scale)
                 for gc, xc in copies],
                (3 * x.numel() + 2 * c + scale.numel()) * x.element_size()
                + (2 * c + 2 * scale.numel()) * 4, 30 * x.numel(), "f32",
                iters=iters)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (wt, bs, scale, scale.roll(1, dims=1))]
            with torch.enable_grad():
                route = time_ms(
                    [lambda gc=gc, xc=xc.detach().requires_grad_():
                     ln_film_route_bwd(gc, xc, *leaves)
                     for gc, xc in copies], iters)[1]
            log(f"ln_film_bwd {dn} {b}x{c}x{h}x{w}: layer_norm_route_ms "
                f"{route:.4f} (torch.autograd.grad of F.layer_norm over a "
                "channels-last view and the FiLM's multiply-add; a "
                "yardstick the port does not call)")
            stats.shapes["ln_film_bwd"][(dn, b, c, h, w)]["route_ms"] = route
            del copies
        torch.cuda.empty_cache()


def check_warp_bwd(dev, g, stats):
    """`affine_warp_bwd` at the CR step's nine STN maps, batch 8."""
    from hifidiff_tpu_torch.ops import warp

    b = CR_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        for c, h, w in WARP_SHAPES:
            x, gr = (torch.randn(b, c, h, w, generator=g, device=dev)
                     .to(dtype) for _ in range(2))
            for kind, (base, spread) in THETAS_BWD.items():
                theta = torch.tensor(base, device=dev) + spread * torch.randn(
                    b, 2, 3, generator=g, device=dev)
                coef = warp.pixel_coef(theta, h, w)
                dx, dcoef = warp.warp_bwd(gr, x, coef)
                ok = stats.compare_rel(
                    "affine_warp_bwd", f"{dn} {b}x{c}x{h}x{w} {kind}",
                    (dx, dcoef), warp.warp_bwd_plain(gr, x, coef),
                    (BWD_REL[dn], DCOEF_REL))
                same_bits("affine_warp_bwd", f"{dn} {b}x{c}x{h}x{w} {kind}",
                          lambda: warp.warp_bwd(gr, x, coef))
                if ok and kind == "out_of_bounds" and \
                        float((dx == 0).float().mean()) < 0.2:
                    fail(f"affine_warp_bwd {dn} {c}x{h}x{w}: corners outside "
                         "the image got a gradient")
                if ok and kind == "identity" and \
                        not float(dcoef.abs().max()) > 0:
                    fail(f"affine_warp_bwd {dn} {c}x{h}x{w}: no slope at "
                         "the identity")
                if kind != "random":
                    continue
                # what autograd asks for where only one input wants a gradient
                only_dx = warp.warp_bwd(gr, x, coef, need_dcoef=False)
                only_dcoef = warp.warp_bwd(gr, x, coef, need_dx=False)
                if only_dx[1] is not None or only_dcoef[0] is not None:
                    fail(f"affine_warp_bwd {dn} {c}x{h}x{w}: a gradient "
                         "that was not asked for")
                ref = warp.warp_bwd_plain(gr, x, coef)
                stats.compare_rel(
                    "affine_warp_bwd",
                    f"{dn} {b}x{c}x{h}x{w} dx alone, dcoef alone",
                    (only_dx[0], only_dcoef[1]), ref,
                    (BWD_REL[dn], DCOEF_REL))
                if not (torch.equal(only_dx[0], dx)
                        and torch.equal(only_dcoef[1], dcoef)):
                    fail(f"affine_warp_bwd {dn} {c}x{h}x{w}: dx alone or "
                         "dcoef alone differs from the call with both")
                grid = F.affine_grid(theta, list(x.shape),
                                     align_corners=False).to(dtype)

                def library():
                    # the library's backward of F.grid_sample (bilinear,
                    # zeros, align_corners=False): dx and d(grid); the small
                    # product that takes d(grid) to dtheta is left out
                    return torch.ops.aten.grid_sampler_2d_backward(
                        gr, x, grid, 0, 0, False, [True, True])

                # g and x read, dx written, the coefficients; about 40
                # float32 operations per element
                stats.measure(
                    "affine_warp_bwd", (dn, b, c, h, w),
                    f"{dn} {b}x{c}x{h}x{w}",
                    lambda: warp.warp_bwd(gr, x, coef),
                    lambda: warp.warp_bwd_plain(gr, x, coef),
                    3 * x.numel() * x.element_size() + 2 * coef.numel() * 4,
                    40 * x.numel(), "f32", library=library)


def branch_error(out, ref, x):
    """How far `out` is from `ref` in what a block adds to its input `x`:
    the norm of (out - ref) over the norm of (ref - x)."""
    ref, x = ref.float(), x.float()
    return float((out.float() - ref).norm() / (ref - x).norm())


def centre_tap_only(pack):
    """The pack with the off-centre taps of its position mix set to 0 (on a
    1x1 map there are none)."""
    sp = pack.hw * pack.hw
    keep = torch.zeros_like(pack.vec_dw)
    centre = [p * sp + p for p in range(sp)]
    keep[centre] = pack.vec_dw[centre]
    return pack._replace(vec_dw=keep)


def block_controls(pack):
    """{what is left out: the pack without it}: blocks that a check of the
    fused block must tell from the block itself."""
    w = pack.weights
    gate_one, no_gamma = pack.vec_c.clone(), pack.vec_c.clone()
    gate_one[3] = 1.0   # vec_c rows: beta, gamma, s_sca, b_sca, ...
    no_gamma[1] = 0.0
    controls = {
        "the SCA gate": pack._replace(
            vec_c=gate_one, weights=(w[0], torch.zeros_like(w[1]), *w[2:])),
        "the second branch": pack._replace(vec_c=no_gamma)}
    if pack.hw > 1:
        controls["the off-centre taps"] = centre_tap_only(pack)
    return controls


# the kernels of the fused block's chain, in launch order
CHAIN = ("ln1", "w1", "sca", "w3", "ln2", "w4", "w5")
# the kernel each launch of the chain runs, as the profiler names it
CHAIN_KERNELS = tuple("ln_rows_kernel" if k.startswith("ln") else "gemm_kernel"
                      for k in CHAIN)


def _rows_like(x, m):
    return torch.randn(m, x.shape[1], device=x.device).to(x.dtype)


def five_products(rows, pooled, ws):
    """The shapes of the fused block's five products: (M, C) rows through
    W1, W3, W4, W5 and (B, C) pooled rows through Wsca; `ws` are the five
    (cin, cout) matrices."""
    w1, wsca, w3, w4, w5 = ws
    return rows @ w1, pooled @ wsca, rows @ w3, rows @ w4, rows @ w5


def check_fused_block(dev, g, stats):
    """The fused block at the path's two shapes, bf16 maps, with bf16 and
    with int8 weights, on perturbed and amplified weights: the outputs
    element by element, and what the block adds to its input, where the
    controls must fail. Returns, per shape, (key, label, calls) for
    `report_chain_splits`: the profiler runs once every timing is taken."""
    from hifidiff_tpu_torch.nn.layers import quantize_module_
    from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock
    from hifidiff_tpu_torch.ops import naf_block
    from hifidiff_tpu_torch.random_weights import (amplify_naf_blocks_,
                                                   perturb_)

    chains = []
    for c, hw in FUSED_SHAPES:
        for wname in ("bf16", "int8"):
            torch.manual_seed(SEED)
            blk = ConditionalNAFBlock(c, 512)
            amplify_naf_blocks_(perturb_(
                blk, torch.Generator().manual_seed(SEED)))
            if wname == "int8" and quantize_module_(blk) != 6:
                fail(f"cnaf_small C={c}: expected the five 1x1 convolutions "
                     "and mlp.1 to take int8 weights")
            blk = blk.to(dev, torch.bfloat16).eval()
            x = torch.randn(BATCH, c, hw, hw, generator=g,
                            device=dev).bfloat16()
            film = (0.2 * torch.randn(1, 4 * c, generator=g,
                                      device=dev)).bfloat16()
            pack = blk.fused_pack(hw, torch.bfloat16)
            label = f"bfloat16 {BATCH}x{c}x{hw}x{hw} {wname} weights"
            with torch.inference_mode():
                out = naf_block.fused_cnaf_block_small(x, film, pack)
                again = naf_block.fused_cnaf_block_small(x, film, pack)
                ref = naf_block.fused_cnaf_block_small_plain(x, film, pack)
                std = blk(x, None, film)
                wrong = {what: naf_block.fused_cnaf_block_small(x, film, p)
                         for what, p in block_controls(pack).items()}
            stats.compare("cnaf_small", label, out, ref, BLOCK_TOL)
            if not torch.equal(out, again):
                fail(f"cnaf_small {label}: two runs on the same inputs differ")
            acts = float((ref.float() - x.float()).norm() / x.float().norm())
            err = branch_error(out, ref, x)
            log(f"cnaf_small {label}: the block adds {acts:.3f} of its "
                f"input's norm; kernel vs plain on what it adds: {err:.3e} "
                f"of that norm (limit {BRANCH_TOL:.1e}); the standard path "
                f"of the same block: {branch_error(std, ref, x):.3e}")
            if acts < 0.1:
                fail(f"cnaf_small {label}: the block is nearly an identity")
            if not err <= BRANCH_TOL:
                fail(f"cnaf_small {label}: kernel and plain version disagree "
                     "on what the block adds")
            for what, bad in wrong.items():
                err = branch_error(bad, ref, x)
                log(f"cnaf_small {label}: control without {what}: {err:.3e}")
                if not err > BRANCH_TOL:
                    fail(f"cnaf_small {label}: the check passes a block "
                         f"without {what}")
            del wrong
            # a sampler's blocks each stream their own weights from device
            # memory: walk copies of the pack that together exceed L2
            wbytes = sum(w.numel() * w.element_size() for w in pack.weights)
            packs = [pack] + [
                pack._replace(weights=tuple(w.clone() for w in pack.weights))
                for _ in range(min(15, math.ceil(120e6 / wbytes)))]
            m, b = BATCH * hw * hw, BATCH
            vec_bytes = sum(t.numel() * t.element_size() for t in
                            (pack.ln, pack.vec_c, pack.vec_2c, pack.vec_dw,
                             film))
            stats.measure(
                "cnaf_small", (c, hw, wname), label,
                [lambda p=p: naf_block.fused_cnaf_block_small(x, film, p)
                 for p in packs],
                [lambda p=p: naf_block.fused_cnaf_block_small_plain(
                    x, film, p) for p in packs],
                2 * x.numel() * 2 + wbytes + vec_bytes,
                2 * c * c * (6 * m + b), "bf16_mma",
                iters=max(20, len(packs)))
            with torch.inference_mode():
                e, gr = time_ms(lambda: blk(x, None, film))
            log(f"cnaf_small {label}: the standard path of the same block "
                f"(ln_film, cuDNN/cuBLAS or matmul_w8) {gr:.4f} ms on the "
                f"card, {e:.4f} ms eagerly from Python")
            chains.append(((c, hw, wname), label, [
                lambda x=x, film=film, p=p:
                naf_block.fused_cnaf_block_small(x, film, p) for p in packs]))
            # the yardstick: the block's five products as torch.matmul on
            # bf16 weights (int8 packs cast once, outside the timing)
            rows = _rows_like(x, m), _rows_like(x, b)
            mats = [[w.to(torch.bfloat16).t() for w in p.weights]
                    for p in packs]
            with torch.inference_mode():
                cublas = time_ms([lambda ws=ws: five_products(*rows, ws)
                                  for ws in mats], max(20, len(packs)))[1]
            log(f"cnaf_small {label}: cublas_bf16_ms {cublas:.4f} (its five "
                "products as torch.matmul on bf16 weights: no LayerNorm, "
                "mix, gates or residuals, and twice the bytes of int8 "
                "weights; a yardstick, not the same function)")
            stats.shapes["cnaf_small"][(c, hw, wname)]["cublas_bf16_ms"] = \
                cublas
            del packs, mats
    return chains


def report_chain_splits(stats, chains):
    """Print, for each fused-block shape of `check_fused_block`, what each
    kernel of its chain adds (`chain_split`)."""
    repeats = 3
    for key, label, calls in chains:
        with torch.inference_mode():
            split, seen = chain_split(calls, CHAIN_KERNELS, repeats)
        log(f"cnaf_small {label}: us each kernel of the chain adds after "
            "the one before it ended (profiler, eager launches): "
            + ("not measured" if split is None else ", ".join(
                f"{k} {t:.1f}" for k, t in zip(CHAIN, split))
                + f"; sum {sum(split):.1f}")
            + f" ({seen} whole chains read, {repeats * len(calls)} launched "
            "under the profiler)")
        stats.shapes["cnaf_small"][key]["chain_us"] = split


def check_matmul_w8(dev, g, stats, shapes):
    from hifidiff_tpu_torch.ops import kernels, quant

    for m, k, n in sorted(shapes):
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        wq, scale = quant.quantize_weight_per_cout(
            torch.randn(n, k, generator=g, device=dev))
        label = f"bfloat16 ({m}, {k}) @ int8 ({n}, {k})"
        plan = (ctypes.c_int * 4)()
        kernels.library().hifidiff_matmul_w8_plan(m, k, n, plan)
        log(f"matmul_w8 {label}: grid of {plan[0]} column tiles x {plan[1]} "
            f"row tiles x {plan[2]} K ranges (the card holds {plan[3]} "
            f"clusters of {plan[2]} at once)")
        with torch.inference_mode():
            out = quant.matmul_w8(x, wq, scale)
            stats.compare("matmul_w8", label, out,
                          quant.matmul_w8_plain(x, wq, scale), GEMM_TOL)
            if not torch.equal(out, quant.matmul_w8(x, wq, scale)):
                fail(f"matmul_w8 {label}: two runs on the same inputs differ")
        wqs = [wq] + [wq.clone()
                      for _ in range(min(15, math.ceil(100e6 / wq.numel())))]
        stats.measure(
            "matmul_w8", (m, k, n), label,
            [lambda w=w: quant.matmul_w8(x, w, scale) for w in wqs],
            [lambda w=w: quant.matmul_w8_plain(x, w, scale) for w in wqs],
            m * k * 2 + n * k + n * 4 + m * n * 2, 2 * m * k * n, "bf16_mma",
            iters=max(20, len(wqs)))
        # the yardstick: torch.matmul on pre-dequantized bf16 weights
        wds = [quant.dequantize(w, scale, torch.bfloat16).t() for w in wqs]
        with torch.inference_mode():
            cublas = time_ms([lambda w=w: x @ w for w in wds],
                             max(20, len(wds)))[1]
        log(f"matmul_w8 {label}: cublas_bf16_ms {cublas:.4f} (torch.matmul "
            "on pre-dequantized bf16 weights: twice the weight bytes, no "
            "column scale; a yardstick, not the same function)")
        stats.shapes["matmul_w8"][(m, k, n)]["cublas_bf16_ms"] = cublas
        del wqs, wds
    x = torch.randn(64, 128, device=dev)
    wq, scale = quant.quantize_weight_per_cout(torch.randn(128, 128,
                                                           device=dev))
    try:
        with torch.inference_mode():
            quant.matmul_w8(x, wq, scale)
        fail("matmul_w8 took float32 activations on the card")
    except TypeError as e:
        log(f"matmul_w8 float32 activations on the card are refused: {e}")


def check_group_norm_silu(dev, g, stats, shapes):
    """At every recorded shape: against the plain version and twice for
    equal bits, in bf16 and f32; the path each shape takes (on chip: the
    map read once from device memory, held by a cluster of blocks; or
    streaming: read three times); the bf16 times on copies of the map
    beyond L2, beside the bf16 pair F.silu(F.group_norm(x))."""
    from hifidiff_tpu_torch.ops import norm

    for c, h, w in sorted(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            x = torch.randn(BATCH, c, h, w, generator=g, device=dev)
            x = x.mul_(2.0).add_(0.5).to(dtype)
            wt, bs = (torch.randn(c, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            label = f"{dn} {BATCH}x{c}x{h}x{w}"
            with torch.inference_mode():
                stats.compare("group_norm_silu", label,
                              norm.group_norm_silu(x, wt, bs, fused=True),
                              norm.group_norm_silu_plain(x, wt, bs), dn)
            same_bits("group_norm_silu", label,
                      lambda: norm.group_norm_silu(x, wt, bs, fused=True))
            chosen = norm.group_norm_silu_plan(x.shape, dtype)
            log(f"group_norm_silu {label}: path {chosen['path']}, cluster "
                f"{chosen['cluster']}, {chosen['slice_bytes']} bytes a block, "
                f"{chosen['blocks_per_sm']} blocks an SM, the map read "
                f"{chosen['reads']} time(s)")
            if dtype == torch.bfloat16 and chosen["path"] != "on_chip":
                fail(f"group_norm_silu {label}: a shape of the path takes "
                     "the streaming path")
            if dtype == torch.bfloat16:
                # one read and one write of the map; about 14 float32
                # operations per element. No single PyTorch call computes
                # GroupNorm + SiLU: the pair below is the nearest route.
                xs = [xc for xc, in l2_copies(x)]
                iters = max(10, len(xs))
                stats.measure(
                    "group_norm_silu", (c, h, w), label,
                    [lambda xc=xc: norm.group_norm_silu(xc, wt, bs,
                                                        fused=True)
                     for xc in xs],
                    [lambda xc=xc: norm.group_norm_silu_plain(xc, wt, bs)
                     for xc in xs],
                    (2 * x.numel() + 2 * c) * x.element_size(),
                    14 * x.numel(), "f32", iters=iters)
                with torch.inference_mode():
                    pair = time_ms([lambda xc=xc: F.silu(F.group_norm(
                        xc, 32, wt, bs, 1e-6)) for xc in xs], iters)
                log(f"group_norm_silu {label}: the bf16 pair "
                    f"F.silu(F.group_norm(x)) {pair[1]:.4f} ms on the card")
                stats.shapes["group_norm_silu"][(c, h, w)]["pair_ms"] = pair[1]
                del xs
            del x
        torch.cuda.empty_cache()
    x = 50.0 + 1e-3 * torch.randn(BATCH, 128, 32, 32, generator=g, device=dev)
    wt, bs = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    with torch.inference_mode():
        stats.compare("group_norm_silu",
                      "float32 near-constant group, mean 50",
                      norm.group_norm_silu(x, wt, bs, fused=True),
                      norm.group_norm_silu_plain(x, wt, bs), NEAR_CONSTANT_TOL)


def build_models():
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.random_weights import perturb_
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    torch.manual_seed(SEED)
    models = (FacialRefiner(), CoarseRestoration(), AutoencoderKL())
    g = torch.Generator().manual_seed(SEED)
    for m in models:
        perturb_(m, g)
        m.eval()
    return models


def make_sampler(models, device, **options):
    """The sampler's entry point on `device` (it moves the models there)."""
    from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                             build_refiner_sampler_split)

    return build_refiner_sampler_split(
        *models, RefinerPipelineConfig(**{"num_inference_steps": STEPS,
                                          **options}), device=device)


def run_stages(sample, lr, post, lat, denoiser=None):
    """(final latents, faces, [(block, x, film, out) of every block of
    `denoiser` that runs as one fused call, at the first denoiser step])."""
    st, seen, hooks = sample.stages, {}, []
    for blk in (denoiser.blocks() if denoiser is not None else ()):
        def keep(blk, args, out):
            if args[0] is not None and blk not in seen \
                    and blk._fused_small_ok(args[0], args[2]):
                seen[blk] = (blk, args[0], args[2], out)

        hooks.append(blk.register_forward_hook(keep))
    try:
        with torch.inference_mode():
            final = st["scan"](*st["prep"](lr, post, lat))
            return final, st["decode"](final), list(seen.values())
    finally:
        for hook in hooks:
            hook.remove()


def disagreement(name, run, ref, rel_tol, level_tol, branch_tol=None):
    """True when `run` (final latents, faces, fused blocks seen) is not
    finite or further from `ref` than the limits: the latents' largest
    difference over their largest value, and the faces' in uint8 levels.
    With `branch_tol`, also when a fused block that the run saw is further
    than that from its plain version on the same input, FiLM row and (newly
    packed) weights, in what it adds to its input (`branch_error`)."""
    from hifidiff_tpu_torch.ops import naf_block

    (final, faces, seen), (ref_final, ref_faces, _) = run, ref
    blocks_ok = True
    if branch_tol is not None:
        errs = collections.defaultdict(list)
        for blk, x, film, out in seen:
            blk.clear_fused_packs()
            with torch.inference_mode():
                plain = naf_block.fused_cnaf_block_small_plain(
                    x, film, blk.fused_pack(x.shape[2], x.dtype))
            errs[f"{x.shape[1]} ch {x.shape[2]}x{x.shape[3]}"].append(
                branch_error(out, plain, x))
        for shape, e in errs.items():
            log(f"{name}: the {len(e)} fused blocks at {shape}, first step, "
                f"vs their plain version on what they add: "
                f"{min(e):.3e} to {max(e):.3e} (limit {branch_tol:.1e})")
            blocks_ok = blocks_ok and all(v <= branch_tol for v in e)
        blocks_ok = blocks_ok and bool(errs)
    scale = max(1.0, float(ref_final.abs().max()))
    lat_err = float((final.float().cpu() - ref_final.float().cpu())
                    .abs().max())
    face_err = int((faces.cpu().int() - ref_faces.cpu().int()).abs().max())
    log(f"{name}: final latents max_abs_diff={lat_err:.3e} (scale "
        f"{scale:.3f}, rel {lat_err / scale:.3e}; limit {rel_tol:.1e}), "
        f"uint8 faces max diff={face_err} levels (limit {level_tol})")
    return not (bool(torch.isfinite(final).all()) and blocks_ok
                and lat_err <= rel_tol * scale and face_err <= level_tol)


@contextlib.contextmanager
def recording(training=False):
    """Count, by shape, the calls that reach each kernel's wrapper while the
    block runs: {kernel: Counter({shape: calls})}. The wrappers and their
    launch counts are untouched; the callers' references are wrapped. A map's
    key is (C, H, W) on the sampler's paths (batch 128, bf16) and
    (dtype, B, C, H, W) with `training`."""
    from hifidiff_tpu_torch.nn import layers, naf
    from hifidiff_tpu_torch.ops import norm, quant, warp
    from hifidiff_tpu_torch.vae import model as vae_model

    def weights(pack):
        return "int8" if pack.weights[0].dtype == torch.int8 else "bf16"

    def map_key(x, *a, **k):
        return (dtype_name(x.dtype), *x.shape) if training \
            else tuple(x.shape[1:])

    points = (
        ("ln_film", layers, "ln_film", map_key),
        ("affine_warp", warp, "warp", map_key),
        ("ln_film_bwd", norm, "ln_film_bwd", map_key),
        ("affine_warp_bwd", warp, "warp_bwd", map_key),
        ("matmul_w8", quant, "matmul_w8",
         lambda x, wq, *a: (x.shape[0], x.shape[1], wq.shape[0])),
        ("group_norm_silu", vae_model, "group_norm_silu",
         lambda x, *a, fused=False, **k: tuple(x.shape[1:]) if fused
         else None),
        ("cnaf_small", naf, "fused_cnaf_block_small",
         lambda x, film, pack, *a: (x.shape[1], x.shape[2], weights(pack))))
    seen = {name: collections.Counter() for name in KERNELS}
    with contextlib.ExitStack() as stack:
        for kernel, module, attr, key in points:
            def shim(*a, _orig=getattr(module, attr), _key=key,
                     _seen=seen[kernel], **k):
                shape = _key(*a, **k)
                if shape is not None:
                    _seen[shape] += 1
                return _orig(*a, **k)

            stack.enter_context(patched(module, attr, shim))
        yield seen


def fusable_blocks(den):
    """The blocks of the denoiser that `fuse_small_naf` runs as one fused
    call each at LATENT x LATENT latents. The side of a block's map is
    halved after every encoder stage and doubled before every decoder
    stage."""
    n = len(den.encoders)
    sides = [LATENT >> i for i, e in enumerate(den.encoders) for _ in e] \
        + [LATENT >> n] * len(den.middle_blks) \
        + [LATENT >> (n - 1 - i) for i, d in enumerate(den.decoders)
           for _ in d]
    return [blk for blk, side in zip(den.blocks(), sides)
            if blk.will_fuse(side)]


def expected_launches(refiner, cr, vae, fuse_small_naf=False,
                      fused_gn_silu=False):
    """The launches of one sampler call that the module tree gives; None
    where only `> 0` is asked."""
    blocks = refiner.denoiser.blocks()
    n_fused = len(fusable_blocks(refiner.denoiser)) if fuse_small_naf else 0
    return {"ln_film": 2 * (len(blocks) - n_fused) * STEPS,
            "affine_warp": sum(hasattr(m, "fc_loc") for m in cr.modules()),
            "cnaf_small": n_fused * STEPS,
            "group_norm_silu": sum(vae.gn_silu_sites()) if fused_gn_silu
            else 0,
            "matmul_w8": None, "ln_film_bwd": 0, "affine_warp_bwd": 0}


def timed_call(sample, lr, post, lat):
    st = sample.stages
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        ev[0].record()
        prep = st["prep"](lr, post, lat)
        ev[1].record()
        final = st["scan"](*prep)
        ev[2].record()
        st["decode"](final)
        ev[3].record()
    torch.cuda.synchronize()
    return {name: ev[a].elapsed_time(ev[b])
            for name, (a, b) in zip(("prep", "scan", "decode", "total"),
                                    ((0, 1), (1, 2), (2, 3), (0, 3)))}


def spy_gradients(state):
    """Keep a CPU copy of the gradients that each `apply_gradients` call of
    `state` finds."""
    seen, apply = {}, state.apply_gradients

    def wrapped():
        seen.clear()
        seen.update({n: p.grad.detach().float().cpu()
                     for n, p in state.module.named_parameters()
                     if p.grad is not None})
        apply()

    state.apply_gradients = wrapped
    return seen


def train_inputs(rng, batch, latent=LATENT):
    """Seeded inputs of one train step, on the CPU: LR and target faces with
    four facial-component patch images, and the refiner step's draws."""
    lr, gt = (torch.from_numpy(rng.uniform(0, 1, (batch, 3, 128, 128))
                               .astype(np.float32)) for _ in range(2))
    patches = torch.zeros(batch, 4, 3, 128, 128)
    for b in range(batch):
        for k in range(4):
            t0, l0 = rng.integers(0, 96, 2)
            patches[b, k, :, t0:t0 + 32, l0:l0 + 32] = \
                gt[b, :, t0:t0 + 32, l0:l0 + 32]
    normal = [torch.from_numpy(rng.standard_normal(
        (batch, 4, latent, latent)).astype(np.float32)) for _ in range(3)]
    t = torch.from_numpy(rng.integers(0, 1000, batch))
    return {"lr": lr, "gt": gt, "patches": patches}, (*normal, t)


def make_train_state(kind, models, device, capturable=False):
    """(state, step, cr) of the CR or the refiner step on float32 copies of
    `models` (refiner, cr, vae), through the entry points a trainer calls;
    `cr` is the CR under training, or the refiner step's frozen one.
    `capturable`: the optimizer a captured step needs (`--cuda-graphs`)."""
    from hifidiff_tpu_torch.train import optim, steps

    refiner, cr, vae = (copy.deepcopy(m).float() for m in models)
    if kind == "cr":
        state = steps.TrainState.create(cr, train_optim(kind, capturable),
                                        device=device)
        return state, steps.make_cr_train_step(device=device), cr
    optim.apply_freeze_mask_(refiner, optim.refiner_freeze_mask(refiner))
    state = steps.TrainState.create(refiner, train_optim(kind, capturable),
                                    device=device)
    return state, steps.make_refiner_train_step(cr, vae, device=device), cr


def train_optim(kind, capturable=False):
    """`make_optim` of the CR step (Adam) or the refiner step (AdamW without
    warm-up: the first steps must move the weights)."""
    from hifidiff_tpu_torch.train import optim

    if kind == "cr":
        return functools.partial(optim.adam, capturable=capturable)
    return functools.partial(optim.adamw_cosine, warmup_steps=0,
                             total_steps=1000, capturable=capturable)


def captured_twin(kind, state):
    """A state on a capturable optimizer over a copy of `state`'s module (on
    the card, frozen as the step wants it), for the same step."""
    from hifidiff_tpu_torch.train import steps

    return steps.TrainState.create(copy.deepcopy(state.module),
                                   train_optim(kind, capturable=True),
                                   device=state.device)


def run_train(kind, models, device, inputs, n_steps, capturable=False):
    """Take `n_steps` steps of the CR or the refiner step on `device` and
    return {loss, grads} of the first step and {params, stats} after the
    last, all on the CPU."""
    state, step, _ = make_train_state(kind, models, device, capturable)
    grads = spy_gradients(state)
    out = {}
    for i, (batch, draws) in enumerate(inputs[:n_steps]):
        _, metrics = step(state, batch, *(draws if kind == "refiner" else ()))
        if i == 0:
            out["loss"] = float(metrics["loss"])
            out["grads"] = dict(grads)
    out["params"] = {n: p.detach().float().cpu()
                     for n, p in state.module.named_parameters()}
    out["stats"] = {n: b.detach().float().cpu()
                    for n, b in state.batch_stats.items()}
    out["lr"] = float(state.optimizer.defaults["lr"])
    return out


def train_disagreement(name, run, ref, n_steps):
    """True when `run` is further from `ref` (both from `run_train`) than
    the limits of phase 8. With `n_steps` 1 only the first step's loss and
    gradients are compared."""
    loss_rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
    top = max(float(g.norm()) for g in ref["grads"].values())
    worst, worst_name = 0.0, ""
    for n, g in ref["grads"].items():
        err = float((run["grads"][n] - g).norm()) / max(
            float(g.norm()), TRAIN_GRAD_FLOOR * top)
        if not err <= worst:
            worst, worst_name = err, n
    log(f"{name}: loss {run['loss']:.6f} vs {ref['loss']:.6f} (rel "
        f"{loss_rel:.2e}, limit {TRAIN_LOSS_REL:.0e}); "
        f"{len(ref['grads'])} gradients, worst relative difference "
        f"{worst:.2e} at {worst_name} (limit {TRAIN_GRAD_REL:.0e})")
    bad = not (math.isfinite(run["loss"]) and loss_rel <= TRAIN_LOSS_REL
               and worst <= TRAIN_GRAD_REL)
    if n_steps > 1:
        one = ref["lr"] * n_steps
        over = total = 0
        far = 0.0
        for n in ref["grads"]:      # the trained parameters
            diff = (run["params"][n] - ref["params"][n]).abs()
            over += int((diff > TRAIN_PARAM_LR * one).sum())
            total += diff.numel()
            far = max(far, float(diff.max()))
        stats = max((float((run["stats"][n] - b).abs().max()
                           / b.abs().max().clamp_min(1e-30))
                     for n, b in ref["stats"].items()), default=0.0)
        frozen = max((float((run["params"][n] - p).abs().max())
                      for n, p in ref["params"].items()
                      if n not in ref["grads"]), default=0.0)
        log(f"{name}: after {n_steps} steps {over} of {total} trained "
            f"entries differ by more than {TRAIN_PARAM_LR} learning rates "
            f"per step (limit {TRAIN_PARAM_SHARE:.0e} of them), the "
            f"farthest by {far / one:.3f} (limit {TRAIN_PARAM_FAR}), frozen "
            f"parameters "
            f"differ by {frozen:.1e} (limit 0); BatchNorm statistics "
            f"rel {stats:.2e} (limit {TRAIN_STATS_REL:.0e}, "
            f"{len(ref['stats'])} tensors)")
        bad = bad or over > TRAIN_PARAM_SHARE * total \
            or far > TRAIN_PARAM_FAR * one \
            or frozen > 0 or not stats <= TRAIN_STATS_REL
    return bad


def state_tensors(state):
    """Everything a train step writes, by name: parameters, buffers,
    gradients, optimizer state and EMA of `state`."""
    out = {f"module.{k}": v for k, v in state.module.state_dict().items()}
    names = {}
    for n, p in state.module.named_parameters():
        names[id(p)] = n
        if p.grad is not None:
            out[f"grad.{n}"] = p.grad
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"optim.{names[id(p)]}.{k}"] = v
    for n, e in (state.ema_params or {}).items():
        out[f"ema.{n}"] = e
    return out


def differing(got, want):
    """The names whose tensors are not equal (`torch.equal`). A gradient
    that a captured step zeroed in place where the eager one dropped it
    counts as equal where it is zero: a fresh one holds zeros."""
    bad = [k for k in got.keys() ^ want.keys()
           if not (k in got and k.startswith("grad.")
                   and not bool(got[k].any()))]
    both = [k for k in got if k in want]
    same = [got[k].shape == want[k].shape for k in both]
    # one host read for all of them: `torch.equal` reads the host per tensor
    ne = torch.stack([torch.ne(got[k], want[k]).any() if ok
                      else torch.ones((), dtype=torch.bool,
                                      device=got[k].device)
                      for k, ok in zip(both, same)]).tolist() if both else []
    return bad + [k for k, differ in zip(both, ne) if differ]


def train_batch(gen, batch, dev):
    """A seeded batch of the CR and refiner steps on the card: LR and target
    faces, and patch images cut from the target."""
    data = {k: torch.rand(batch, 3, 128, 128, generator=gen, device=dev)
            for k in ("lr", "gt")}
    data["patches"] = data["gt"][:, None] * (torch.rand(
        batch, 4, 1, 128, 128, generator=gen, device=dev) > 0.9)
    return data


def replay_vs_eager(step, eager, state, batches, teacher=None,
                    seed=SEED + 20, tamper=None):
    """Capture `step` on `state` (a copy of `eager`, both on capturable
    optimizers) for `batches[0]`'s shapes, then per batch one eager step of
    `eager` and one call of the capture, each drawing from a generator
    seeded (seed + i) on the card: the first call of each kind (one, two
    under accumulation) is the state's step that warms up and captures, the
    others replay. Returns the capture and {capture_s (the capturing
    calls'), at_capture (their launches, less the eager steps'), launched
    (launches from Python during the replays), differ (per call, the names
    of the metrics and state tensors that differ), losses}. `tamper(i,
    state)` runs before call i (a control)."""
    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.train import graphs

    dev = state.device
    lead = () if teacher is None else (teacher,)
    kernels.reset_launches()
    cap = graphs.capture_train_step(step, state, batches[0], teacher=teacher)
    out = dict(capture_s=0.0, at_capture={}, launched=0, differ=[],
               losses=[])
    for i, batch in enumerate(batches):
        def draws():
            return {"generator": torch.Generator(device=dev).manual_seed(
                seed + i)} if cap.takes_generator else {}

        _, want = step(eager, *lead, batch, **draws())
        if tamper is not None:
            tamper(i, state)
        before, warm = dict(kernels.LAUNCHES), len(cap.warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, got = cap.run(batch, **draws())
        torch.cuda.synchronize()
        new = {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items()
               if n != before.get(k, 0)}
        if len(cap.warm) > warm:
            out["capture_s"] += time.perf_counter() - t0
            for k, n in new.items():
                out["at_capture"][k] = out["at_capture"].get(k, 0) + n
        else:
            out["launched"] += sum(new.values())
        out["differ"].append(differing(got, want) + differing(
            state_tensors(state), state_tensors(eager)))
        out["losses"].append((float(got["loss"]), float(want["loss"])))
    return cap, out


def check_captured_steps(models, dev, smi):
    """Phase 7's captured steps (after 8, f32 with TF32 off): the refiner
    step at batch 32 and the CR step at batch 8, full width, captured as
    CUDA graphs (`train/graphs.py`); the first call (the state's step that
    warms up and captures) and CAPTURE_STEPS replays, each against an eager
    step of a copy of the state on the same capturable optimizer, the same
    batch and the same draws, every metric and state tensor equal; the
    warm-up's and the capture's launches twice what the module tree gives a
    step, none from Python in a replay. The control: the refiner's replay
    after one whose learning-rate write was skipped (the device-tensor rate
    left unwritten) must differ."""
    for kind, batch in (("refiner", REFINER_BATCH), ("cr", CR_BATCH)):
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        eager, step, cr = make_train_state(kind, models, dev,
                                           capturable=True)
        state = captured_twin(kind, eager)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        control = kind == "refiner"
        calls = 1 + CAPTURE_STEPS
        batches = [train_batch(gen, batch, dev)
                   for _ in range(calls + control)]

        def skip_write(i, st):
            if i == calls - 1:    # the write after this replay
                st.scheduler._write = lambda: None

        torch.cuda.reset_peak_memory_stats()
        with deterministic(cudnn=True):
            cap, r = replay_vs_eager(step, eager, state, batches,
                                     tamper=skip_write if control else None)
        peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
        label = f"captured {kind} train step, batch {batch}, f32"
        want = {k: 2 * n for k, n in expected_train_launches(
            state.module, cr).items() if n}
        checked = r["differ"][:calls]
        log(f"{label}: warmed up and captured in {r['capture_s']:.2f} s "
            f"(launched {r['at_capture']}, twice the module tree's step: "
            f"{want}); that call and {CAPTURE_STEPS} replays against eager "
            f"steps on the capturable optimizer: tensors that differ "
            f"{[len(d) for d in checked]} (of {len(state_tensors(state))}"
            f" and the metrics), losses {r['losses'][:calls]}; "
            f"launches from Python in the replays {r['launched']}; the two "
            f"states, the capture and the steps peak {peak_gb:.2f} GB over "
            f"what was resident [{smi}]")
        if r["at_capture"] != want or r["launched"] or any(checked):
            fail(f"{label}: a replay is not the eager step, or its launches "
                 f"are wrong: {[d[:4] for d in checked]}")
        if control:
            log(f"control, a replay after the rate's write was skipped: "
                f"{len(r['differ'][-1])} tensors differ")
            if not r["differ"][-1]:
                fail(f"{label}: a replay on a rate left unwritten passes")
        del eager, state, cap, step, cr, batches
    torch.cuda.empty_cache()


def expected_train_launches(module, cr=None):
    """The launches of one train step of `module` that the module tree
    gives; `cr` is the CR under training (then `module` itself), the frozen
    CR of the IDC or refiner step, or None (the VAE and denoiser steps). One
    warp per STN of the CR, each with a backward launch while the STN has
    trainable parameters (none in a frozen CR). A denoiser's blocks (a
    refiner's, or a stage-3 Denoiser's own) run two `ln_film` each, each
    with a backward launch while the `time_mlp` that feeds every block's
    FiLM is trainable (else only in blocks with trainable parameters);
    under `remat` a block whose backward runs runs its forward, and its two
    `ln_film`, once more."""
    expected = {}
    if cr is not None:
        stns = [m for m in cr.modules() if hasattr(m, "fc_loc")]
        expected.update(affine_warp=len(stns), affine_warp_bwd=sum(
            any(p.requires_grad for p in m.parameters()) for m in stns))
    den = getattr(module, "denoiser", module)
    if hasattr(den, "blocks"):
        blocks = den.blocks()
        films = any(p.requires_grad for p in den.time_mlp.parameters())
        trained = len(blocks) if films else sum(
            any(p.requires_grad for p in blk.parameters()) for blk in blocks)
        expected.update(ln_film=2 * (len(blocks) + den.remat * trained),
                        ln_film_bwd=2 * trained)
    return expected


def device_busy_ms(one):
    """(ms the card spends in kernels and copies during one call of `one`,
    the call's wall ms under the profiler, the six kernels with the most
    device time as (name, ms, launches)), from `torch.profiler`: the sum over
    the device's own events (one stream, so they do not overlap). The rows of
    the host's operators and of annotations such as `Optimizer.step` repeat
    the times of the kernels under them and are left out. The first is None
    where the profiler saw no device time. The host's operators are not
    traced: a scan has some 40,000 launches, and the profiler spends far
    longer on their operators' rows than the scan takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=device_us, reverse=True)
    total_us = sum(device_us(e) for e in rows)
    top = [(e.key[:48], round(device_us(e) / 1e3, 2), e.count)
           for e in rows[:6]]
    return (total_us / 1e3 if total_us > 0 else None), wall, top


def backward_launches(one, node):
    """The device launches (kernels and memsets) of each call of the
    autograd node `node` (`_LnFilmBackward`, `_AffineWarpBackward`) in one
    call of `one`, in call order, from `torch.profiler` with the host's
    operators traced: the device events linked to the range of the node's
    own call and to the ranges under it. The engine's range around it
    (`evaluate_function: ...`) also holds autograd's sums of the gradient
    into the gradients of the input's other uses, which are not the
    backward's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()

    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)

    return [launches(e) for e in prof.events() if e.name == node]


def timed_train(kind, models, dev, batch, stats_out):
    """Warm up; take one step with the launch counts set to 0 before and
    read after, in which the shapes reaching the wrappers are recorded; then
    capture the step as CUDA graphs on a second state (capturable
    optimizer; its first call, the warm-up and the capture, launches twice
    the module tree's step) and time TIMED_STEPS eager steps and as many
    replays in turns (host clock around a synchronised step; no launch from
    Python in a replay), and the host's check of the capture's state key
    before a replay. Returns (launches, recorded shapes, profile):
    `profile()` takes one more eager step under the profiler for the card's
    idle share, profiles one replay of the timed capture for the same,
    writes the step's entries of `stats_out` and frees the states; it is
    called once every timing of the run is taken. The eager peak memory is
    what its state and a step add to what was resident; the captured
    step's is what its state, buffers and graph pool reserve."""
    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.train import graphs

    resident = torch.cuda.memory_allocated()
    state, step, cr = make_train_state(kind, models, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = train_batch(gen, batch, dev)
    kw = {} if kind == "cr" else {"generator": gen}

    def one():
        _, m = step(state, data, **kw)
        torch.cuda.synchronize()
        return float(m["loss"])

    one()                                      # the warm-up step
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with recording(training=True) as seen:     # counted and recorded at once
        loss = one()
    peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    launches = dict(kernels.LAUNCHES)
    expected = expected_train_launches(state.module, cr)
    label = f"{kind} train step, batch {batch}, float32"
    log(f"{label}: launches in one step: {launches}; the module tree gives "
        f"{expected}")
    for kernel, n in launches.items():
        if n != expected.get(kernel, 0) or n != sum(seen[kernel].values()):
            fail(f"{label}: {kernel} launched {n} times, the module tree "
                 f"gives {expected.get(kernel, 0)}, the recorded calls "
                 f"{sum(seen[kernel].values())}")
    if not math.isfinite(loss):
        fail(f"{label}: loss {loss}")

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    captured = graphs.capture_train_step(step, captured_twin(kind, state),
                                         data)
    g_kw = {} if kind == "cr" else {
        "generator": torch.Generator(device=dev).manual_seed(SEED)}

    def replay():
        _, m = captured.run(data, **g_kw)
        torch.cuda.synchronize()
        return float(m["loss"])

    kernels.reset_launches()
    replay()                      # the warm-up and the capture
    graph_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    at_capture = {k: n for k, n in kernels.LAUNCHES.items() if n}
    want = {k: 2 * n for k, n in expected.items() if n}
    if at_capture != want:
        fail(f"{label}: the warm-up and the capture launched {at_capture}, "
             f"not twice the module tree's step {want}")
    times, g_times = [], []
    launched = 0
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        one()
        times.append((time.perf_counter() - t0) * 1e3)
        before = sum(kernels.LAUNCHES.values())
        t0 = time.perf_counter()
        replay()
        g_times.append((time.perf_counter() - t0) * 1e3)
        launched += sum(kernels.LAUNCHES.values()) - before
    if launched:
        fail(f"{label}: {launched} launches from Python in the replays")
    key_ms = []
    for _ in range(KEY_CHECKS):
        t0 = time.perf_counter()
        held = captured.key.holds()
        key_ms.append((time.perf_counter() - t0) * 1e3)
        if not held:
            fail(f"{label}: the capture's state key does not hold")
    key_ms = statistics.median(key_ms)
    log(f"{label}: the state key's check before a replay takes {key_ms:.3f} "
        f"ms of the host (median of {KEY_CHECKS}; "
        f"{len(captured.key.params)} parameters, "
        f"{sum(len(d) for d in captured.key.buffers)} buffers)")
    med, g_med = statistics.median(times), statistics.median(g_times)
    for what, ts, m, gb in (("eager", times, med, peak_gb),
                            ("captured", g_times, g_med, graph_gb)):
        log(f"{label}, {what}: {batch / m * 1e3:.2f} images/s median "
            f"({batch / max(ts) * 1e3:.2f}-{batch / min(ts) * 1e3:.2f} "
            f"over {len(ts)} steps, taken in turns), {m:.1f} ms per step, "
            + ("peak memory" if what == "eager" else "state, buffers and "
               "graph pool reserve") + f" {gb:.2f} GB, loss {loss:.4f}")
        log(f"  {label}, {what}, ms per step: {[round(t, 1) for t in ts]}")

    def profile():
        nonlocal state, step, captured
        busy, profiled_ms, top = device_busy_ms(one)
        # the backward kernel's node, and the most device launches one of
        # its calls may take
        node, kernel, most = (("_LnFilmBackward", "ln_film_bwd", 2)
                              if kind == "refiner" else
                              ("_AffineWarpBackward", "affine_warp_bwd", 3))
        per_call = backward_launches(one, node)
        log(f"  {label}: device launches of each {kernel} call (profiled "
            f"step, kernels and memsets): {per_call}")
        if not per_call or max(per_call) > most:
            fail(f"{label}: a {kernel} call took more than {most} device "
                 f"launches, or none was seen: {per_call}")
        g_busy, g_profiled, g_top = device_busy_ms(replay)
        state = step = captured = None
        torch.cuda.empty_cache()
        for what, b, m, p_ms, t, gb in (
                ("eager", busy, med, profiled_ms, top, peak_gb),
                ("captured", g_busy, g_med, g_profiled, g_top, graph_gb)):
            if b is not None and b > m:     # no share can come of that
                log(f"  {label}, {what}: the profiler counts {b:.1f} ms of "
                    f"device time, more than the median step: left out")
                b = None
            stats_out[f"{label}, {what}"] = dict(
                ms=m, images_per_s=batch / m * 1e3, peak_gb=gb,
                key_check_ms=key_ms if what == "captured" else None,
                device_busy_ms=b, profiled_step_ms=p_ms,
                device_idle_share=None if b is None else 1.0 - b / m)
            log(f"  {label}, {what}: the card's kernels take "
                + ("not measured" if b is None
                   else f"{b:.1f} ms of one profiled step ({p_ms:.1f} ms on "
                   f"the host's clock): idle {1.0 - b / m:.3f} of the median "
                   f"step; most device time: {t}"))

    return launches, seen, profile


def other_steps_captured(models, dev, smi):
    """The other eight train steps at OTHER_CAPTURE_BATCH rows, f32, each
    captured as CUDA graphs, its capturing calls (the warm-ups) and
    CAPTURE_STEPS replays held to as many eager steps of a copy of the
    state on the same capturable optimizer and draws, every metric and
    state tensor equal: the IDC, denoiser, cached-denoiser (with `remat`,
    the denoiser's blocks under a checkpoint), VAE, progressive-distillation
    (stratified student steps, a host draw), tiny-denoiser, tiny-CR and
    tiny-autoencoder steps; the denoiser's and the tiny CR's with
    accumulation over two mini-steps and an EMA (two graphs). Every module
    at its default widths and depths, as the CLIs build them: the frozen CR
    and VAE, the IDC (ResNet-50), `Denoiser()`, the distillation teacher a
    `FacialRefiner()` with its ResNet-50 IDC, the distilled student a copy
    of it, the tiny denoiser at `train_tiny_dn`'s `--tiny-width` 64 with
    the teacher's IDC, and the tiny CR and autoencoder. Each: a finite loss
    and a parameter that moved."""
    from hifidiff_tpu_torch.models.denoiser import Denoiser
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.models.tiny_cr import TinyCR
    from hifidiff_tpu_torch.train import distill, optim, steps
    from hifidiff_tpu_torch.vae import tiny

    cr, vae = (copy.deepcopy(m).float().to(dev) for m in models[1:])
    idc = copy.deepcopy(models[0].idc).float()
    vae_trained = copy.deepcopy(vae)   # `vae` is frozen by the steps below
    b = OTHER_CAPTURE_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def faces(*keys):
        return {k: torch.rand(b, 3, 128, 128, generator=gen, device=dev)
                for k in keys}

    def cached(_):
        with torch.no_grad():
            mean, logvar = vae.to(dev).moments(faces("x")["x"] * 2.0 - 1.0)
        return {"mean": mean, "logvar": logvar}

    def adam(params):
        return optim.adam(params, capturable=True)

    def adamw(params, accumulate=1):
        return optim.adamw_cosine(params, warmup_steps=0,
                                  accumulate_steps=accumulate,
                                  capturable=True)

    def student():
        tiny_dn = FacialRefiner(width=TINY_DN_WIDTH)
        tiny_dn.idc.load_state_dict(distilled.idc.state_dict())
        return tiny_dn

    torch.manual_seed(SEED)
    with torch.device(dev):    # the distillation steps' teacher
        distilled = FacialRefiner().eval()
    # module, optimizer, EMA decay, step, teacher, batch
    kinds = {
        "idc": lambda: (idc, adam, 0.0,
                        steps.make_idc_train_step(cr, device=dev), None,
                        lambda: faces("lr", "gt", "other")),
        "denoiser": lambda: (
            Denoiser(), functools.partial(adamw, accumulate=2), 0.999,
            steps.make_denoiser_train_step(vae, device=dev), None,
            lambda: faces("x")["x"]),
        "cached denoiser (remat)": lambda: (
            Denoiser(remat=True), adamw, 0.0,
            steps.make_denoiser_train_step_cached(device=dev), None,
            lambda: cached(None)),
        "vae": lambda: (vae_trained, adamw, 0.0, steps.make_vae_train_step(
            device=dev), None, lambda: faces("image")),
        "distill": lambda: (
            copy.deepcopy(distilled).requires_grad_(True), adamw, 0.0,
            distill.make_distill_train_step(
                cr, vae, 10, substeps=2, clip_sample=True, stratified=True,
                device=dev), distilled, lambda: faces("lr", "gt")),
        "tiny_dn": lambda: (student(), adamw, 0.0,
                            distill.make_tiny_dn_train_step(
                                cr, vae, rollout_steps=2, device=dev),
                            distilled, lambda: faces("lr", "gt")),
        "tiny_cr": lambda: (TinyCR(), functools.partial(adamw, accumulate=2),
                            0.999, distill.make_tiny_cr_train_step(
                                cr, device=dev), None,
                            lambda: faces("lr", "gt")),
        "tae": lambda: (torch.nn.ModuleDict({"enc": tiny.TinyEncoder(),
                                             "dec": tiny.TinyDecoder()}),
                        adamw, 0.0, distill.make_tae_train_step(
                            vae, device=dev), None, lambda: faces("image"))}
    readings = {}
    for name, make in kinds.items():
        t0 = time.perf_counter()
        with torch.device(dev):    # the new modules drawn on the card
            module, make_optim, ema, step, teacher, batch = make()
        eager = steps.TrainState.create(copy.deepcopy(module), make_optim,
                                        ema_decay=ema, device=dev)
        state = steps.TrainState.create(copy.deepcopy(module), make_optim,
                                        ema_decay=ema, device=dev)
        before = [p.detach().clone() for p in state.module.parameters()
                  if p.requires_grad]
        warm_ups = 1 if state.accumulate_steps == 1 else 2
        batches = [batch() for _ in range(warm_ups + CAPTURE_STEPS)]
        with deterministic(cudnn=True):
            cap, r = replay_vs_eager(step, eager, state, batches,
                                     teacher=teacher)
        moved = max(float((p.detach() - q).abs().max()) for p, q in zip(
            (p for p in state.module.parameters() if p.requires_grad),
            before))
        loss = r["losses"][-1][0]
        readings[name] = dict(
            capture_s=round(r["capture_s"], 2), replays=cap.replays,
            differ=[len(d) for d in r["differ"]], moved=moved, loss=loss,
            draws=list(cap.draws), graphs=len(cap.graphs),
            s=round(time.perf_counter() - t0, 2))
        if any(r["differ"]) or r["launched"] \
                or cap.replays != CAPTURE_STEPS \
                or not (math.isfinite(loss) and moved > 0):
            fail(f"captured {name} train step: tensors that differ "
                 f"{[d[:4] for d in r['differ']]}, launches from Python "
                 f"{r['launched']}, loss {loss}, largest move {moved}")
        del module, eager, state, cap, step, teacher, before, batches
    torch.cuda.empty_cache()
    log(f"the other train steps captured at batch {b}, f32, at their "
        f"default widths, the warm-ups and {CAPTURE_STEPS} replays each "
        f"against eager steps [{smi}]: " + json.dumps(readings))


def film_ignored(x, w, b, scale, shift, eps):
    """`ln_film` with the FiLM left out: a control's wrong path."""
    from hifidiff_tpu_torch.ops import norm

    return norm.ln_film(x, w, b, torch.zeros_like(scale),
                        torch.zeros_like(shift), eps)


def float_faces_disagree(name, out, ref, tol):
    """True when the float faces `out` are not finite or further than `tol`
    from `ref` anywhere."""
    err = float((out.cpu() - ref.cpu()).abs().max())
    log(f"{name}: float faces max_abs_diff={err:.3e} (limit {tol:.1e})")
    return not (bool(torch.isfinite(out).all()) and err <= tol)


def check_new_paths(cpu_models, dev, inputs, on_card):
    """Phase 10: every path the split sampler has beyond the exact default
    one, the monolithic sampler and the unconditional sampler, at full
    width, batch 2, NEW_PATH_STEPS steps, f32 (TF32 off): on the card
    through the kernels and on the host CPU through the plain versions, to
    phase 4's limits; each with a control that must fail them. The
    monolithic sampler must also give the split sampler's bits on the
    card."""
    from hifidiff_tpu_torch.models.denoiser import Denoiser
    from hifidiff_tpu_torch.models.tiny_cr import TinyCR
    from hifidiff_tpu_torch.nn import layers
    from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                             build_refiner_sampler,
                                             build_refiner_sampler_split,
                                             build_unconditional_sampler)
    from hifidiff_tpu_torch.random_weights import perturb_
    from hifidiff_tpu_torch.vae.tiny import tiny_autoencoder_pair

    torch.manual_seed(SEED + 2)
    tiny_cpu = dict(zip(("tiny_enc", "tiny_dec"), tiny_autoencoder_pair(8)),
                    tiny_cr=TinyCR())
    unet = perturb_(Denoiser(), torch.Generator().manual_seed(SEED + 2))
    card_models = [copy.deepcopy(m).to(dev) for m in cpu_models]
    tiny_card = {k: copy.deepcopy(m).to(dev) for k, m in tiny_cpu.items()}
    limits = (LATENT_REL_TOL, FACE_LEVEL_TOL)
    cfg = dict(num_inference_steps=NEW_PATH_STEPS, latent_size=LATENT)

    def split(device, seams=False, **options):
        models, tiny, args = (cpu_models, tiny_cpu, inputs) \
            if device == "cpu" else (card_models, tiny_card, on_card)
        sample = build_refiner_sampler_split(
            *models, RefinerPipelineConfig(**cfg, **options), device=device,
            **(tiny if seams else {}))
        run = run_stages(sample, *args)
        if device != "cpu":
            torch.cuda.synchronize()
        return run

    t0 = time.perf_counter()
    ddim = {"card": split(dev), "cpu": split("cpu")}
    paths = {   # name: (options, the control: "ddim" or "film")
        "sampler=dpmpp": (dict(sampler="dpmpp"), "ddim"),
        "cache_interval=3": (dict(cache_interval=3), "ddim"),
        "hoist_invariants=False": (dict(hoist_invariants=False), "film"),
        "sample_posterior=False": (dict(sample_posterior=False), "ddim"),
        "clip_sample": (dict(clip_sample=True), "ddim"),
        "tiny_enc + tiny_dec + tiny_cr": (dict(seams=True), "ddim")}
    card_runs = {}
    for name, (options, control) in paths.items():
        card = card_runs[name] = split(dev, **options)
        host = split("cpu", **options)
        label = f"{name}, {NEW_PATH_STEPS} steps, f32"
        if disagreement(f"{label}: card vs CPU", card, host, *limits):
            fail(f"{name}: card and CPU runs disagree")
        if control == "ddim":
            wrong, what = ddim["card"], "the exact DDIM path"
        else:
            with patched(layers, "ln_film", film_ignored):
                wrong, what = split(dev, **options), "the FiLM left out"
        if not disagreement(f"control for {name}: {what} on the card",
                            wrong, host, *limits):
            fail(f"the {name} check passes {what}")
    if disagreement(f"exact DDIM, {NEW_PATH_STEPS} steps, f32: card vs CPU",
                    ddim["card"], ddim["cpu"], *limits):
        fail("exact DDIM: card and CPU runs disagree")

    mono = build_refiner_sampler(*card_models, RefinerPipelineConfig(**cfg),
                                 device=dev)(on_card[0],
                                             posterior_noise=on_card[1],
                                             latents_noise=on_card[2])
    same = torch.equal(mono, ddim["card"][1])
    log(f"build_refiner_sampler on the card gives the split sampler's bits: "
        f"{same}")
    if not same:
        fail("build_refiner_sampler and the split sampler differ on the card")
    mono_run = (ddim["card"][0], mono, [])
    if disagreement("build_refiner_sampler: card vs CPU", mono_run,
                    ddim["cpu"], *limits):
        fail("build_refiner_sampler: card and CPU runs disagree")
    if not disagreement("control for build_refiner_sampler: the DPM++ run "
                        "on the card", card_runs["sampler=dpmpp"],
                        ddim["cpu"], *limits):
        fail("the build_refiner_sampler check passes the DPM++ run")

    def unconditional(device, film=True):
        model = unet if device == "cpu" else copy.deepcopy(unet).to(device)
        sample = build_unconditional_sampler(
            model, cpu_models[2] if device == "cpu" else card_models[2],
            num_inference_steps=NEW_PATH_STEPS, latent_size=LATENT, batch=2,
            device=device)
        noise = (inputs if device == "cpu" else on_card)[2]
        with contextlib.ExitStack() as stack:
            if not film:
                stack.enter_context(patched(layers, "ln_film", film_ignored))
            return sample(latents_noise=noise)

    host = unconditional("cpu")
    if float_faces_disagree("build_unconditional_sampler: card vs CPU",
                            unconditional(dev), host, UNCOND_TOL):
        fail("build_unconditional_sampler: card and CPU runs disagree")
    if not float_faces_disagree("control for build_unconditional_sampler: "
                                "the FiLM left out on the card",
                                unconditional(dev, film=False), host,
                                UNCOND_TOL):
        fail("the unconditional check passes a path without FiLM")
    log(f"new paths checked in {time.perf_counter() - t0:.1f} s")


def timed_replay(sample, captured, lr, noise):
    """One timing of the captured stages: each stage's graph replayed
    between CUDA events (the inputs loaded first), then one whole
    `sample` call that replays them (its host work, the inputs' copies in
    and the output's copy included) as "total"."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.inference_mode():
        captured.load((lr, noise["posterior_noise"], noise["latents_noise"]))
        ev[0].record()
        for i, graph in enumerate(captured.graphs.values()):
            graph.replay()
            ev[i + 1].record()
        torch.cuda.synchronize()
        ev[4].record()
        sample(lr, **noise)
        ev[5].record()
    torch.cuda.synchronize()
    return {"prep": ev[0].elapsed_time(ev[1]),
            "scan": ev[1].elapsed_time(ev[2]),
            "decode": ev[2].elapsed_time(ev[3]),
            "total": ev[4].elapsed_time(ev[5])}


def report_calls(label, calls, batch, steps, smi):
    """faces/s (median and spread of the calls' totals) and per-stage
    medians."""
    med = {k: statistics.median(v) for k, v in calls.items()}
    tot = calls["total"]
    log(f"{label}: bf16 batch {batch}, {steps}, uint8 I/O, {len(tot)} timed "
        f"calls: faces/s={batch / med['total'] * 1e3:.2f} median "
        f"({batch / max(tot) * 1e3:.2f}-{batch / min(tot) * 1e3:.2f} over "
        f"the calls); median total {med['total']:.1f} ms, prep "
        f"{med['prep']:.1f}, scan {med['scan']:.1f}, decode "
        f"{med['decode']:.1f} ms [{smi}]")
    for stage, v in calls.items():
        log(f"  {label} {stage} ms per call: {[round(x, 1) for x in v]}")
    return med


def warm_and_check(name, sample, lr, noise, eager_out):
    """Capture `sample`'s stages (`warm_compile`) and hold one replay to
    `eager_out` bit for bit. Returns (capture, launches counted in the
    warm-up and the capture, the host's ms for warm_compile)."""
    from hifidiff_tpu_torch.ops import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    captured = sample.warm_compile(lr, **noise)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    at_capture = dict(kernels.LAUNCHES)
    before = sample.replays
    out = sample(lr, **noise)
    same = torch.equal(out, eager_out)
    log(f"{name}: warm_compile {warm_s:.2f} s; a replay gives the eager "
        f"call's bits: {same}")
    if not same or sample.replays != before + 1:
        fail(f"{name}: the graph replay differs from the eager call, or did "
             "not replay")
    return captured, at_capture


def graph_timings(models, dev, lr, noise, smi):
    """Phase 11: other samplers of the default configuration timed under
    graphs at batch 128: each captured, one replay held to its eager call
    bit for bit, TIMED_REPLAYS calls timed, the captures dropped."""
    from hifidiff_tpu_torch.ops import kernels

    for label, options in GRAPH_SAMPLERS.items():
        sample = make_sampler(models, dev, **options)
        eager_out = sample(lr, **noise)
        captured, at_capture = warm_and_check(label, sample, lr, noise,
                                              eager_out)
        calls = collections.defaultdict(list)
        for _ in range(TIMED_REPLAYS):
            for stage, ms in timed_replay(sample, captured, lr,
                                          noise).items():
                calls[stage].append(ms)
        if sample.replays != 1 + TIMED_REPLAYS \
                or dict(kernels.LAUNCHES) != at_capture:
            fail(f"{label}: {sample.replays} replays, not "
                 f"{1 + TIMED_REPLAYS}, or launches from Python in them: a "
                 "call ran eagerly")
        report_calls(f"{label}, graphs", calls, BATCH,
                     f"{options.get('num_inference_steps', STEPS)} steps",
                     smi)
        del captured
        sample.clear_compiled()
        torch.cuda.empty_cache()



def _post_raw(host, port, img):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", "/infer", img.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"POST /infer: {resp.status} {body[:200]!r}")
    return np.frombuffer(body, np.uint8).reshape(img.shape)


def check_png_request(host, port, cfg, sample, batcher, launched,
                      eager_call, smi, body=None, label=None):
    """One image request sent as image/png to the server: by default a
    MP_SIDE^2 procedural face written by `png_filtered` (phase 15), or
    `body` (phase 19's Adam7 and 16-bit files): answered 200 with a PNG;
    the batch the server launched equal to the port's decode (as the JAX
    handler's PIL reads it) and PIL-bicubic resize of the body
    (`image_io.decode_image`, `resize_pil`); the face equal to an eager
    call on that batch with the launch's generator, which is the face a
    raw request of those pixels gets from that launch."""
    import http.client

    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data.image_io import decode_image, decode_png
    from hifidiff_tpu_torch.data.resize import resize_pil

    if body is None:
        face = (proc.render_face(proc._identity_params(SEED, 5), 0.4,
                                 MP_SIDE) * 255).astype(np.uint8)
        body = png_filtered(face)
        label = f"a {MP_SIDE}x{MP_SIDE} PNG request (phase 15)"
    before = serving_counts(sample, batcher)
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", "/infer", body, {"Content-Type": "image/png"})
        resp = conn.getresponse()
        status, ctype, answer = (resp.status, resp.getheader("Content-Type"),
                                 resp.read())
    finally:
        conn.close()
    check_no_eager(label, sample, batcher, before)
    counter, batch = launched[-1]
    pixels = resize_pil(decode_image(body, reader="pil"),
                        (cfg.size, cfg.size), "bicubic")
    served = decode_png(answer) if status == 200 else None
    ref = eager_call(batch, counter)[0]
    same_in = np.array_equal(batch[0], pixels)
    same_out = served is not None and np.array_equal(served, ref)
    log(f"server, {label}: {status} {ctype}, {len(answer)} bytes; the "
        f"launched batch (bucket {batch.shape[0]}) holds the port's decode "
        f"and PIL-bicubic resize {same_in}; the face equal to the eager "
        f"call on that batch with launch {counter}'s generator {same_out} "
        f"[{smi}]")
    if status != 200 or ctype != "image/png" or not (same_in and same_out):
        fail(f"server: {label} answered {status} {answer[:200]!r}, input "
             f"equal {same_in}, face equal {same_out}")


def format_bodies():
    """Phase 19's two bodies for the server: a CELEBA_SIDE^2 procedural
    face as an Adam7 16-bit RGB PNG, and as a 16-bit grey PNG whose
    samples stay below 256 (PIL reads them as they are; cv2 would read
    their high byte, 0)."""
    from hifidiff_tpu_torch.data import procedural as proc

    face = (proc.render_face(proc._identity_params(SEED, 6), -0.2,
                             CELEBA_SIDE) * 255).astype(np.int64)
    return {"an Adam7 16-bit RGB PNG request (phase 19)":
                png_file(face * 257, 16, 2, interlace=1),
            "a 16-bit grey PNG request (phase 19)":
                png_file(face[..., 1:2], 16, 0)}


@contextlib.contextmanager
def held_to_plain(stats):
    """While the block runs, every call of `ln_film` and of the warp is also
    computed by its plain version on the same inputs and compared, to phase
    3's limits (TOL by dtype); yields {(kernel, shape, dtype): [calls, worst
    error, all within the limit]}, filled as the calls come."""
    from hifidiff_tpu_torch.nn import layers
    from hifidiff_tpu_torch.ops import norm, warp

    seen = {}

    def shim(name, orig, plain):
        def call(*a, **k):
            out = orig(*a, **k)
            ok, err = close(out, plain(*a, **k), dtype_name(out.dtype))
            key = (name, tuple(a[0].shape), dtype_name(out.dtype))
            n, worst, good = seen.get(key, (0, 0.0, True))
            seen[key] = (n + 1, max(worst, err), good and ok)
            stats.err[name] = max(stats.err[name], err)
            return out
        return call

    with patched(layers, "ln_film", shim("ln_film", layers.ln_film,
                                          norm.ln_film_plain)), \
            patched(warp, "warp", shim("affine_warp", warp.warp,
                                       warp.warp_plain)):
        yield seen


def serving_counts(sample, batcher):
    from hifidiff_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES), sample.replays, batcher.batches


def check_no_eager(label, sample, batcher, before):
    """Fail unless the launches served since `before` (serving_counts) were
    all replays and no kernel was launched from Python."""
    launches, replays, batches = serving_counts(sample, batcher)
    n = batches - before[2]
    log(f"server, {label}: {n} launches served, the sampler's replays rose "
        f"by {replays - before[1]}; kernel launches from Python "
        f"{ {k: v - before[0][k] for k, v in launches.items()} }")
    if replays - before[1] != n or launches != before[0] or n == 0:
        fail(f"server, {label}: a launch was not a replay ({n} launches, "
             f"{replays - before[1]} replays, launches from Python "
             f"{launches} against {before[0]})")


def median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_eval_cli(paths, models, smi):
    """The eval CLI on the card at its defaults (f32, batch 4, float I/O,
    DDIM-50, clip 3.0) over EVAL_PROCEDURAL procedural faces' held-out
    split, reading the weight files `paths`: its PSNR and SSIM must be
    finite, and its `ln_film` and warp launches EVAL_BATCHES calls' worth of
    what the module tree gives (`models`: refiner, cr, vae)."""
    from hifidiff_tpu_torch.cli import test_refiner
    from hifidiff_tpu_torch.ops import kernels

    per_call = expected_launches(*models)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = test_refiner.main([
        "--refiner-ckpt", paths["refiner"], "--cr-ckpt", paths["cr"],
        "--vae-ckpt", paths["vae"], "--procedural", str(EVAL_PROCEDURAL),
        "--grid-every", "0", "--seed", str(SEED)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: kernels.LAUNCHES[k] for k in ("ln_film", "affine_warp")}
    want = {k: EVAL_BATCHES * per_call[k] for k in launched}
    log(f"test_refiner on the card (f32, batch 4, DDIM-50, "
        f"{EVAL_BATCHES} batches of procedural faces): psnr "
        f"{got['psnr']:.4f}, ssim {got['ssim']:.4f}, {seconds:.1f} s with "
        f"the weights' load; kernel launches {launched} (the module tree "
        f"gives {want}) [{smi}]")
    if not all(np.isfinite(got[k]) for k in ("psnr", "ssim")) \
            or launched != want:
        fail(f"test_refiner on the card: {got}, launches {launched} against "
             f"{want}")
    torch.cuda.empty_cache()


def check_server(models, dev, smi, stats):
    """Phase 12: the port's server at full width through its entry point.
    The seeded perturbed weights (`models`, float32 on the host) are written
    as reference-named torch files and read by `create_server` through its
    checkpoint flags, at its defaults (batch 16, bf16, exact DDIM-50, clip
    3.0) with buckets 1 and 4. Checked: three buckets x three stages
    captured; each face served at concurrency 1 equal to an eager call on
    the same image with the same (seed, counter) generator, the next
    counter's call different; a 3-request burst served by one bucket-4
    launch, each face equal to the eager call on the padded batch; every
    `ln_film` and warp call of an eager bucket-1 call against its plain
    version; every launch while serving a replay. Then the load generator
    at SERVE_CONCURRENCIES, the host's share of a launch, and a launch with
    the captures dropped, which must raise. Before the server starts, the
    eval CLI on the same files (`check_eval_cli`). Returns the
    kernels' launch counts from the cold start through the serving (all of
    them in the warm-up: serving only replays)."""
    import tempfile
    import threading

    from hifidiff_tpu_torch.cli import serve, serve_bench
    from hifidiff_tpu_torch.cli.common import seeded_generator
    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.pipeline import build_refiner_sampler_split

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, m in zip(("refiner", "cr", "vae"), models):
            paths[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(m.state_dict(), paths[name])
        log(f"server: weights written as reference-named torch files "
            f"({sum(os.path.getsize(p) for p in paths.values()) / 1e9:.2f} "
            f"GB) in {time.perf_counter() - t0:.1f} s")
        check_eval_cli(paths, models, smi)
        cfg = serve.Config(port=0, buckets=SERVE_BUCKETS, seed=SEED,
                           refiner_ckpt=paths["refiner"],
                           cr_ckpt=paths["cr"], vae_ckpt=paths["vae"])
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        kernels.reset_launches()
        t0 = time.perf_counter()
        httpd, batcher = serve.create_server(cfg)
        cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    run = batcher.run_fn
    sample = run.sampler
    warm = dict(kernels.LAUNCHES)
    log(f"server: cold start {cold_s:.2f} s (kernel library "
        f"{run.timings['kernel_build_s']:.2f} s, weights loaded "
        f"{run.timings['load_s']:.2f} s, {len(run.buckets)} buckets x 3 "
        f"stages captured {run.timings['capture_s']:.2f} s, one launch a "
        f"bucket {run.timings['first_launch_s']:.2f} s); the server's card "
        f"memory after the warm-up: "
        f"{(torch.cuda.memory_allocated() - mem0[0]) / 1e9:.2f} GB "
        f"allocated, {(torch.cuda.memory_reserved() - mem0[1]) / 1e9:.2f} "
        f"GB reserved (the graphs' pools included) [{smi}]")
    per_call = expected_launches(*run.models)
    want = {k: 2 * len(run.buckets) * (v or 0) for k, v in per_call.items()}
    log(f"server: kernel launches in the warm-up (an eager call and a "
        f"capture a bucket): {warm}")
    if run.buckets != [1, 4, 16] or sorted(run.captured) != run.buckets \
            or any(list(c.graphs) != ["prep", "scan", "decode"]
                   for c in run.captured.values()) \
            or sample.replays != len(run.buckets) or warm != want:
        fail(f"server: buckets {run.buckets}, captured "
             f"{ {b: list(c.graphs) for b, c in run.captured.items()} }, "
             f"{sample.replays} replays in the warm-up, launches {warm} "
             f"(the module tree gives {want})")

    launched = []   # (counter, batch) of each launch the batcher makes

    def recorded(imgs):
        launched.append((run.counter + 1, imgs))
        return run(imgs)

    batcher.run_fn = recorded
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address
    rng = np.random.default_rng(SEED + 12)
    try:
        # -- faces at concurrency 1, and a 3-request burst ---------------
        before = serving_counts(sample, batcher)
        singles = []
        for _ in range(SERVE_EAGER_CHECKS):
            img = rng.integers(0, 256, (cfg.size, cfg.size, 3), np.uint8)
            singles.append((img, _post_raw(host, port, img), run.counter))
        burst = [rng.integers(0, 256, (cfg.size, cfg.size, 3), np.uint8)
                 for _ in range(3)]
        outs = [None] * 3

        def client(i):
            outs[i] = _post_raw(host, port, burst[i])

        # a window wider than the default for the burst, so that a slow
        # thread start cannot split it
        batcher.max_wait_s = 0.2
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        batcher.max_wait_s = cfg.max_wait_ms / 1e3
        burst_counter, padded = launched[-1]
        check_no_eager("concurrency 1 and the burst", sample, batcher,
                       before)
        if padded.shape[0] != 4 or batcher.batches - before[2] != \
                SERVE_EAGER_CHECKS + 1:
            fail(f"server: the 3-request burst went to a batch of "
                 f"{padded.shape[0]}, not one bucket-4 launch")

        # -- the same faces from eager calls, on copies of the server's
        # models: a sampler built over the models themselves would move
        # them (`.to()` renews the blocks' pack generations) and so drop
        # the server's captures
        eager = build_refiner_sampler_split(*copy.deepcopy(run.models),
                                            sample.config, device=dev)

        def eager_call(batch, counter):
            return eager(torch.from_numpy(batch).to(dev),
                         generator=seeded_generator(SEED, counter, dev)
                         ).cpu().numpy()

        for img, served, counter in singles:
            ref = eager_call(img[None], counter)[0]
            other = eager_call(img[None], counter + 1)[0]
            log(f"server, launch {counter} (bucket 1): served face equal to "
                f"the eager call {np.array_equal(served, ref)}; control, "
                f"the next counter's call: "
                f"{int(np.abs(other.astype(int) - ref).max())} levels off")
            if not np.array_equal(served, ref):
                fail(f"server: launch {counter}'s face differs from the "
                     "eager call with its generator")
            if np.array_equal(other, ref):
                fail("server: the next counter's eager call gives the same "
                     "face: the check cannot fail")
        ref = eager_call(padded, burst_counter)
        slots = [next(j for j in range(len(padded))
                      if np.array_equal(padded[j], img)) for img in burst]
        same = [np.array_equal(out, ref[j]) for out, j in zip(outs, slots)]
        log(f"server, launch {burst_counter} (the burst, bucket 4, slots "
            f"{slots}): faces equal to the eager call on the padded batch: "
            f"{same}")
        if not all(same):
            fail("server: a face of the padded bucket-4 launch differs from "
                 "the eager call")

        # -- phase 15 on this server: a PNG body, decoded by the port's
        # decoder and PIL-bicubic resized, against an eager call on the same
        # pixels with the launch's generator
        check_png_request(host, port, cfg, sample, batcher, launched,
                          eager_call, smi)
        # -- phase 19 on this server: an Adam7 16-bit colour body, a 16-bit
        # grey one, a lossy WebP, an animated WebP and a CMYK JPEG, read as
        # the JAX handler's PIL reads them
        for label, body in {**format_bodies(), **webp_body(),
                            **animated_and_cmyk_bodies()}.items():
            check_png_request(host, port, cfg, sample, batcher, launched,
                              eager_call, smi, body, label)

        # -- ln_film and the warp against their plain versions at bucket 1 -
        with held_to_plain(stats) as seen:
            eager_call(singles[0][0][None], singles[0][2])
        for (name, shape, dtype), (n, worst, ok) in sorted(seen.items()):
            log(f"server, bucket 1: {name} {dtype} {shape}: {n} calls, "
                f"max_abs_err vs plain {worst:.3e} ok={ok}")
            if not ok:
                fail(f"server, bucket 1: {name} at {shape} disagrees with "
                     "its plain version")
        counts = collections.Counter()
        for (name, _, _), (n, _, _) in seen.items():
            counts[name] += n
        if dict(counts) != {k: per_call[k] for k in ("ln_film",
                                                     "affine_warp")}:
            fail(f"server, bucket 1: {dict(counts)} calls held to the "
                 "plain versions, not the module tree's")
        del eager

        # -- load ------------------------------------------------------------
        before = serving_counts(sample, batcher)
        t0 = time.perf_counter()
        phases = serve_bench.run_load(host, port, cfg.size,
                                      SERVE_CONCURRENCIES, SERVE_REQUESTS)
        log(f"server: load generator {time.perf_counter() - t0:.1f} s")
        check_no_eager("load", sample, batcher, before)
        for ph in phases:
            log(f"server load c={ph['concurrency']}: p50 {ph['p50_ms']:.2f} "
                f"ms, p95 {ph['p95_ms']:.2f} ms, "
                f"{ph['throughput_faces_per_sec']:.2f} faces/s, "
                f"{ph['launches']} launches, mean fill "
                f"{ph['mean_fill']:.2f}, {ph['errors']} errors, "
                f"{ph['requests']} requests [{smi}]")
            if ph["errors"] or ph["requests"] != \
                    ph["concurrency"] * SERVE_REQUESTS:
                fail(f"server load c={ph['concurrency']}: {ph['errors']} "
                     "errors")
        log("server load: " + json.dumps(phases))

        # -- the host's share of a launch ------------------------------------
        key_ms = median_ms(sample._state_key, 2 * SERVE_TIMED)
        for b in (1, 16):
            imgs = rng.integers(0, 256, (b, cfg.size, cfg.size, 3),
                                np.uint8)
            graphs = list(run.captured[b].graphs.values())

            def replay():
                for graph in graphs:
                    graph.replay()
                torch.cuda.synchronize()

            call_ms = median_ms(lambda: run(imgs), SERVE_TIMED)
            replay_ms = median_ms(replay, SERVE_TIMED)
            log(f"server, bucket {b}: a launch (run(): the upload through "
                f"pinned memory, the generator, the key, the three replays, "
                f"the faces' copy back) {call_ms:.2f} ms, the three replays "
                f"alone {replay_ms:.2f} ms: {call_ms - replay_ms:.2f} ms of "
                f"host work outside the replay, of which the key over "
                f"{len(sample._state_key()[2])} parameters and buffers "
                f"(`_state_key`) {key_ms:.3f} ms [{smi}]")

        # -- a launch that can no longer replay must fail, not run eagerly
        sample.clear_compiled()
        try:
            run(imgs[:1])
            fail("server: a launch with the captures dropped ran eagerly "
                 "without an error")
        except RuntimeError as e:
            if "ran eagerly" not in str(e):
                raise
            log(f"server: with the captures dropped, a launch raises: {e}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
    del run, sample
    torch.cuda.empty_cache()
    return warm


# -- phase 13: the training CLIs ---------------------------------------------

def default_expected(module, cr, args, kwargs):
    return expected_train_launches(module, cr)


def counting_factory(factory, records, peak, expected=default_expected):
    """`factory`, a train-step factory that a CLI calls, made to count each
    step it takes: the step's ms (the card synchronised before and after),
    the memory it adds to what was resident, and the launches of every
    kernel beside what the module tree gives (`expected(module, cr, args,
    kwargs)` of the step's module, the frozen CR among the factory's
    arguments and the step's other arguments; by default
    `expected_train_launches`). A call with `update=False` (a validation
    pass through the step) is recorded as such. The per-step peak resets
    the card's peak counter; `peak[0]` keeps the run's peak across them."""
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.ops import kernels

    def make(*args, **kwargs):
        step = factory(*args, **kwargs)
        frozen = next((a for a in args if isinstance(a, CoarseRestoration)),
                      None)

        def counted(state, *a, **k):
            torch.cuda.synchronize()
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            out = step(state, *a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            top = torch.cuda.max_memory_allocated()
            peak[0] = max(peak[0], top)
            module = state.module
            cr = module if isinstance(module, CoarseRestoration) else frozen
            records.append(dict(
                ms=ms, peak_gb=(top - resident) / 1e9,
                val=k.get("update", True) is False,
                launches={n: kernels.LAUNCHES[n] - c
                          for n, c in before.items()
                          if kernels.LAUNCHES[n] != c},
                expected={n: c for n, c in expected(
                    module, cr, a, k).items() if c}))
            return out

        return counted

    return make


def run_cli(label, cli, argv, factories, batch, smi,
            expected=default_expected):
    """`cli.main(argv)` with the steps of its step `factories` counted
    (`counting_factory`, with `expected`): every step's launches must be
    what the module tree gives. Logs the steps' ms, their median and
    images/s (validation passes through the step apart), the largest memory
    a step adds to what was resident, the run's peak over what was resident
    before it, and the wall seconds. Returns (main's result, the
    numbers)."""
    records, peak = [], [0]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for name in factories:
            stack.enter_context(patched(cli, name, counting_factory(
                getattr(cli, name), records, peak, expected)))
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
    trained = [r for r in records if not r["val"]]
    ms = [r["ms"] for r in trained]
    med = statistics.median(ms) if ms else None
    out = dict(batch=batch, steps=len(trained), step_ms=ms, median_ms=med,
               images_per_s=None if med is None else batch / med * 1e3,
               step_peak_gb=max((r["peak_gb"] for r in trained),
                                default=None),
               run_peak_gb=(peak[0] - resident) / 1e9, wall_s=wall,
               launches_per_step=trained[0]["launches"] if trained else {},
               val_ms=[r["ms"] for r in records if r["val"]])
    log(f"{label}: {len(trained)} steps at batch {batch}, ms "
        f"{[round(t, 1) for t in ms]} (the first with the warm-up), median "
        + ("-" if med is None else f"{med:.1f} ms, "
           f"{out['images_per_s']:.1f} images/s")
        + f"; a step adds at most {out['step_peak_gb'] or 0:.2f} GB, the run "
        f"peaks {out['run_peak_gb']:.2f} GB over what was resident; "
        f"{wall:.1f} s wall [{smi}]")
    torch.cuda.empty_cache()    # the card is shared from phase 13 on
    for i, r in enumerate(records):
        what = "validation pass" if r["val"] else "step"
        log(f"  {label} {what} {i}: launches {r['launches']}, the module "
            f"tree gives {r['expected']}")
        if r["launches"] != r["expected"]:
            fail(f"{label} step {i}: launches {r['launches']}, the module "
                 f"tree gives {r['expected']}")
    return result, out


def finite_log(label, log_dir, project, name, steps):
    """The JSONL rows a CLI wrote: every value finite, `steps` rows with a
    train loss. Returns the rows."""
    path = os.path.join(log_dir, f"{project}.{name}.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    bad = [r for r in rows if not all(math.isfinite(v) for v in r.values())]
    other = [{k: round(v, 4) for k, v in r.items() if k != "time"}
             for r in rows if "train_loss" not in r]
    log(f"{label}: train losses {[round(v, 5) for v in losses]}; other "
        f"rows {other}")
    if bad or len(losses) != steps:
        fail(f"{label}: {len(losses)} train losses (not {steps}), rows with "
             f"a value that is not finite: {bad}")
    return rows


def first_step_gradients(store):
    """Patch `TrainState.apply_gradients` so that the first call keeps a
    host copy of the gradients it finds in `store["grads"]`."""
    from hifidiff_tpu_torch.train import steps

    real = steps.TrainState.apply_gradients

    def spy(self):
        if "grads" not in store:
            store["grads"] = {n: p.grad.detach().float().cpu()
                              for n, p in self.module.named_parameters()
                              if p.grad is not None}
        real(self)

    return patched(steps.TrainState, "apply_gradients", spy)


def check_recorded_shapes(dev, g, stats, seen, phase="phase 13"):
    """Every map that reached `ln_film`, `ln_film_bwd`, the warp or its
    backward in `phase` ((dtype, B, C, H, W) keys of `recording`), held to
    its plain version and run twice for equal bits: `ln_film` and its
    backward with per-sample FiLM rows 4C apart and with a shared (1, C)
    row, the backward with and without dw and db; the warp and its backward
    at every theta (the forward in f32 bit for bit). A map that an earlier
    call held (`HELD_MAPS`) is not held again."""
    from hifidiff_tpu_torch.ops import norm, warp

    kernels_ = ("ln_film", "ln_film_bwd", "affine_warp", "affine_warp_bwd")
    again = sum(1 for k in kernels_ for m in seen[k] if (k, m) in HELD_MAPS)
    seen = {k: {m for m in seen[k] if (k, m) not in HELD_MAPS}
            for k in kernels_}
    HELD_MAPS.update((k, m) for k in kernels_ for m in seen[k])
    log(f"{phase}: {sum(map(len, seen.values()))} maps held to the plain "
        f"versions, {again} held before")
    for key in sorted(set(seen["ln_film"]) | set(seen["ln_film_bwd"])):
        dn, b, c, h, w = key
        dtype = getattr(torch, dn)
        x, gr = (torch.randn(b, c, h, w, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        wt, bs = (torch.randn(c, generator=g, device=dev).to(dtype)
                  for _ in range(2))
        limits = [BWD_REL[dn]] + [SUM_REL] * 4
        for fb in (b, 1):
            film = (0.3 * torch.randn(fb, 4 * c, generator=g, device=dev)
                    ).to(dtype)
            shift, scale = film.chunk(4, dim=1)[:2]
            label = f"{dn} {b}x{c}x{h}x{w} film_batch={fb} ({phase})"
            if key in seen["ln_film"]:
                with torch.inference_mode():
                    stats.compare("ln_film", label,
                                  norm.ln_film(x, wt, bs, scale, shift),
                                  norm.ln_film_plain(x, wt, bs, scale, shift),
                                  dn)
                same_bits("ln_film", label,
                          lambda: norm.ln_film(x, wt, bs, scale, shift))
            if key not in seen["ln_film_bwd"]:
                continue
            for need_wb in (True, False):
                got = norm.ln_film_bwd(gr, x, wt, bs, scale, need_wb=need_wb)
                ref = norm.ln_film_bwd_plain(gr, x, wt, bs, scale,
                                             need_wb=need_wb)
                keep = [i for i in range(5) if ref[i] is not None]
                stats.compare_rel(
                    "ln_film_bwd", f"{label} need_wb={need_wb}",
                    [got[i] for i in keep], [ref[i] for i in keep],
                    [limits[i] for i in keep])
                same_bits("ln_film_bwd", f"{label} need_wb={need_wb}",
                          lambda: norm.ln_film_bwd(gr, x, wt, bs, scale,
                                                   need_wb=need_wb))
        del x, gr
    for key in sorted(set(seen["affine_warp"])
                      | set(seen["affine_warp_bwd"])):
        dn, b, c, h, w = key
        dtype = getattr(torch, dn)
        x, gr = (torch.randn(b, c, h, w, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        for kind, (base, spread) in THETAS.items():
            theta = torch.tensor(base, device=dev) + spread * torch.randn(
                b, 2, 3, generator=g, device=dev)
            coef = warp.pixel_coef(theta, h, w)
            label = f"{dn} {b}x{c}x{h}x{w} {kind} ({phase})"
            if key in seen["affine_warp"]:
                with torch.inference_mode():
                    out, ref = warp.warp(x, coef), warp.warp_plain(x, coef)
                if stats.compare("affine_warp", label, out, ref, dn) \
                        and dtype == torch.float32 \
                        and not torch.equal(out, ref):
                    fail(f"affine_warp {label}: float32 not bit-equal to "
                         "the plain version")
                same_bits("affine_warp", label, lambda: warp.warp(x, coef))
            if key in seen["affine_warp_bwd"] and kind in THETAS_BWD:
                stats.compare_rel(
                    "affine_warp_bwd", label, warp.warp_bwd(gr, x, coef),
                    warp.warp_bwd_plain(gr, x, coef),
                    (BWD_REL[dn], DCOEF_REL))
                same_bits("affine_warp_bwd", label,
                          lambda: warp.warp_bwd(gr, x, coef))
        del x, gr
    torch.cuda.empty_cache()


# Phase 20 (the module's docstring). (b): the host's rows to phase 4's
# limits, their PSNRs to QUALITY_PSNR_TOL (the latents' 1e-5 moves a PSNR by
# far less). (c): each script's record file and its cuts: the tiny
# autoencoder, tiny CR and tiny denoiser trained one epoch, two distillation
# rounds of 10 steps (both of turbo's students, so that every record has a
# default run's keys), the hard-family IDC at 64 faces, one epoch of
# pretrain_idc (train_cr two: at one its checkpoint interval is 0) and its
# check off. Every record's keys are held to the committed default run's
# record of that name at the repo root.
QUALITY_PSNR_TOL = 0.05
QUALITY_SCRIPTS = {
    "cache_quality": ("CACHE_QUALITY_TORCH.json", []),
    "tae_quality": ("TAE_QUALITY_TORCH.json", ["--tae-epochs", "1"]),
    "tiny_cr_quality": ("TINY_CR_QUALITY_TORCH.json", ["--epochs", "1"]),
    "tiny_dn_quality": ("TINY_DN_QUALITY_TORCH.json", [
        "--epochs", "1", "--tiny-cr-ckpt",
        "runs/torch_tiny_cr_quality/ckpt/convdemo"]),
    "distill_quality": ("DISTILL_QUALITY_TORCH.json",
                        ["--steps-per-round", "10"]),
    "turbo_quality": ("TURBO_QUALITY_TORCH.json", []),
    "idc_hard_demo": ("IDC_HARD_TORCH.json", [
        "--n", "64", "--epochs-cr", "2", "--epochs-idc", "1",
        "--check", "0"])}


def record_keys(rec):
    """The key structure of a record, "run" left out."""
    if isinstance(rec, dict):
        return {k: record_keys(v) for k, v in rec.items() if k != "run"}
    if isinstance(rec, list):
        return [record_keys(v) for v in rec]
    return None


def record_figures(rec):
    """Every float of a record ("run" left out)."""
    if isinstance(rec, dict):
        return [f for k, v in rec.items() if k != "run"
                for f in record_figures(v)]
    if isinstance(rec, list):
        return [f for v in rec for f in record_figures(v)]
    return [rec] if isinstance(rec, float) else []


def quality_scripts(work, ckpt_root, device="cuda"):
    """Phase 20 (a) and (c), in `work`, on the demo's stage files under
    `ckpt_root`, on `device` (the CPU only to rehearse the phase). Returns
    ({"failures", "scripts": {name: {"wall_s", "launches", "record"}}},
    what cache_quality's `evaluate` kept, for (b))."""
    import importlib

    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.scripts import cache_quality

    out, cache_runs = {"failures": [], "scripts": {}, "host": {}}, {}

    def kept(cfg, dev, real=cache_quality.evaluate):
        result, runs = real(cfg, dev)
        cache_runs.update(runs)
        return result, runs

    repo = os.path.dirname(os.path.abspath(__file__))
    here = os.getcwd()
    os.makedirs(work, exist_ok=True)
    os.chdir(work)     # the scripts' run directories are relative
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, (record, cuts) in QUALITY_SCRIPTS.items():
            module = importlib.import_module(
                f"hifidiff_tpu_torch.scripts.{name}")
            argv = ["--out", os.path.join(work, record), "--device", device]
            if name != "idc_hard_demo":
                argv += ["--ckpt-root", ckpt_root]
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            with patched(cache_quality, "evaluate", kept):
                rec = module.main(argv + cuts)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: n - before.get(k, 0)
                        for k, n in kernels.LAUNCHES.items()
                        if n != before.get(k, 0)}
            out["scripts"][name] = {"wall_s": wall, "launches": launches,
                                    "record": rec}
            log(f"phase 20: {name}: {wall:.1f} s wall, launches "
                f"{launches}; record " + json.dumps(
                    {k: v for k, v in rec.items() if k != "run"}))
            figures = record_figures(rec)
            if not figures or not all(map(math.isfinite, figures)):
                out["failures"].append(f"{name}: figures {figures}")
            committed = os.path.join(repo, record)
            if not os.path.exists(committed):
                out["failures"].append(f"{name}: no committed {record}")
                continue
            with open(committed) as f:
                want = record_keys(json.load(f))
            if record_keys(rec) != want:
                out["failures"].append(
                    f"{name}: the record's keys {record_keys(rec)} are not "
                    f"the default run's {want}")
    finally:
        os.chdir(here)
    return out, cache_runs


def host_rows(runs, ckpt_root, failures):
    """Phase 20 (b): cache_quality's exact and interval-2 rows on the host
    CPU against the card's (`runs`, what its `evaluate` kept), outside the
    recording of the card's calls."""
    from hifidiff_tpu_torch.scripts import cache_quality
    from hifidiff_tpu_torch.scripts.common import drift_psnr, gt_metrics

    cfg = cache_quality.parse_config(cache_quality.Config, [])
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    stack = cache_quality.build_stack(dataclasses.replace(
        cfg, ckpt_root=ckpt_root), "cpu")
    noise = {k: v.cpu() for k, v in runs["noise"].items()}
    lr, gt = runs["batch"]["lr"], runs["batch"]["gt"]
    host = {"exact": cache_quality.sample(stack, cfg, lr, noise, "cpu"),
            "intervals/2": cache_quality.sample(stack, cfg, lr, noise, "cpu",
                                                cache_interval=2)}
    seconds = time.perf_counter() - t0

    def apart(name, card, ref):
        scale = max(1.0, float(np.abs(ref[0]).max()))
        lat = float(np.abs(card[0] - ref[0]).max()) / scale
        levels = int(np.abs(np.round(card[1] * 255.0)
                            - np.round(ref[1] * 255.0)).max())
        far = not (np.isfinite(card[0]).all() and lat <= LATENT_REL_TOL
                   and levels <= FACE_LEVEL_TOL)
        log(f"phase 20 (b): {name}: final latents rel {lat:.3e} (limit "
            f"{LATENT_REL_TOL:.0e}), faces {levels} levels (limit "
            f"{FACE_LEVEL_TOL})")
        return far, lat, levels

    res = {"host_s": seconds}
    for row in ("exact", "intervals/2"):
        far, lat, levels = apart(f"{row}, card vs host", runs[row],
                                 host[row])
        card_m = gt_metrics(runs[row][1], gt)
        host_m = gt_metrics(host[row][1], gt)
        d_psnr = abs(card_m[0] - host_m[0])
        res[row] = {"latent_rel": lat, "face_levels": levels,
                    "gt_psnr_card": card_m[0], "gt_psnr_host": host_m[0],
                    "gt_ssim_card": card_m[1], "gt_ssim_host": host_m[1]}
        if row != "exact":
            dc = drift_psnr(runs[row][1], runs["exact"][1])
            dh = drift_psnr(host[row][1], host["exact"][1])
            res[row].update(drift_card=dc, drift_host=dh)
            d_psnr = max(d_psnr, abs(dc - dh))
        log(f"phase 20 (b): {row}: gt PSNR card {card_m[0]:.4f} / host "
            f"{host_m[0]:.4f} dB"
            + (f", drift card {res[row]['drift_card']:.4f} / host "
               f"{res[row]['drift_host']:.4f} dB" if row != "exact" else "")
            + f" (limit {QUALITY_PSNR_TOL} dB)")
        if far or d_psnr > QUALITY_PSNR_TOL:
            failures.append(f"cache_quality {row}: card and host CPU "
                            "disagree")
    control, _, _ = apart("control, the card's interval-2 row vs the host's "
                          "exact row", runs["intervals/2"], host["exact"])
    if not control:
        failures.append("the cache_quality check passes the interval-2 row "
                        "for the exact one")
    log(f"phase 20 (b): the host's two rows {seconds:.1f} s")
    return res


def demo_child(work):
    """Phase 13's `cli/convergence_demo.py` in a process of its own (this
    script with `--demo-child`), on the card at its defaults, `--check`
    included, in `work`, the maps that reach the kernels recorded; then
    phase 20 on its stage files. Writes demo.json there: the check of
    `check_summary` that failed (or None), the wall seconds, the summary,
    the launches and the maps (the demo's and phase 20's), and phase 20's
    results."""
    from hifidiff_tpu_torch.cli import convergence_demo
    from hifidiff_tpu_torch.data import procedural
    from hifidiff_tpu_torch.ops import kernels

    log(f"convergence_demo: the procedural faces' LR protocol resizes with "
        f"{procedural.LR_RESIZE}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    failed = None
    with recording(training=True) as seen:
        try:
            convergence_demo.main([
                "--out-dir", os.path.join(work, "demo"),
                "--log-dir", os.path.join(work, "demo_logs"),
                "--device", "cuda"])
        except AssertionError as e:
            failed = str(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        demo_launches = dict(kernels.LAUNCHES)
        t20 = time.perf_counter()
        ckpt_root = os.path.join(work, "demo", "ckpt")
        try:
            quality, cache_runs = quality_scripts(
                os.path.join(work, "quality"), ckpt_root)
        except Exception as e:   # reported at the join
            quality = {"failures": [f"raised {type(e).__name__}: {e}"],
                       "scripts": {}, "host": {}}
            cache_runs = {}
        torch.cuda.synchronize()
    if cache_runs:
        try:
            quality["host"] = host_rows(cache_runs, ckpt_root,
                                        quality["failures"])
        except Exception as e:
            quality["failures"].append(
                f"(b) raised {type(e).__name__}: {e}")
    del cache_runs
    quality["wall_s"] = time.perf_counter() - t20
    for entry in quality["scripts"].values():
        entry["record"] = {k: v for k, v in entry["record"].items()
                           if k != "run"}
    with open(os.path.join(work, "demo", "convergence.json")) as f:
        summary = json.load(f)
    with open(os.path.join(work, "demo.json"), "w") as f:
        json.dump({"failed": failed, "wall_s": wall, "summary": summary,
                   "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                   "demo_launches": demo_launches,
                   "launches": dict(kernels.LAUNCHES),
                   "phase20": quality,
                   "maps": {k: [[list(m), n] for m, n in c.items()]
                            for k, c in seen.items() if c}}, f)


def start_demo(work):
    """`demo_child` started in `work` beside this process (its output into
    demo.log there); returns the process."""
    with open(os.path.join(work, "demo.log"), "w") as out:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--demo-child", work],
            stdout=out, stderr=subprocess.STDOUT)


def join_demo(proc, work, dev, g, stats, smi):
    """Waits for `start_demo`'s process and prints its output. Fails where
    the process failed, a check of `check_summary` or of phase 20 failed,
    or its launches (the demo's and phase 20's) are not its recorded calls;
    holds the maps that reached the kernels to the plain versions. Returns
    phase 20's launches by script."""
    try:
        rc = proc.wait(timeout=DEMO_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    with open(os.path.join(work, "demo.log")) as f:
        log(f.read().rstrip("\n"))
    path = os.path.join(work, "demo.json")
    if rc != 0 or not os.path.exists(path):
        fail(f"convergence_demo: its process ended with rc {rc}")
        return {}
    with open(path) as f:
        demo = json.load(f)
    failed = demo["failed"]
    log(f"convergence_demo at its defaults: {demo['wall_s']:.1f} s wall "
        "in a process of its own, beside phase 13's training CLIs (the "
        f"card's memory it reserved at most {demo['peak_reserved_gb']:.2f} "
        "GB), "
        + ("every check passed" if failed is None else
           f"check failed: {failed}") + f" [{smi}]")
    log("convergence summary: " + json.dumps(demo["summary"]))
    if failed is not None:
        fail(f"convergence_demo: {failed}")
    quality = demo["phase20"]
    log(f"phase 20: the quality scripts {quality['wall_s']:.1f} s wall "
        "after the demo in its process (the demo's launches "
        f"{demo['demo_launches']}) [{smi}]: " + json.dumps(
            {name: {"wall_s": round(q["wall_s"], 1),
                    "launches": q["launches"]}
             for name, q in quality["scripts"].items()}))
    log("phase 20 (b) [" + smi + "]: " + json.dumps(quality["host"]))
    for what in quality["failures"]:
        fail(f"phase 20: {what}")
    if len(quality["scripts"]) != len(QUALITY_SCRIPTS):
        fail(f"phase 20: {len(quality['scripts'])} of "
             f"{len(QUALITY_SCRIPTS)} scripts ran")
    seen = {k: collections.Counter() for k in KERNELS}
    for kernel, items in demo["maps"].items():
        for shape, n in items:
            seen[kernel][tuple(shape)] += n
    for k, n in demo["launches"].items():
        if n != sum(seen[k].values()):
            fail(f"convergence_demo: {k} launched {n} times, the recorded "
                 f"calls {sum(seen[k].values())}")
    log("convergence_demo maps (dtype, B, C, H, W) -> calls: "
        + json.dumps({k: {"x".join(map(str, m)): n for m, n in v.items()}
                      for k, v in seen.items() if v}))
    check_recorded_shapes(dev, g, stats, seen, phase="convergence_demo")
    return {name: q["launches"] for name, q in quality["scripts"].items()}


# 12 faces at batch 8: a full batch and a short one (4) an epoch, each
# shape captured in the first epoch and replayed in the second, after a
# validation pass (its 4 faces: a quarter of 12, at least 4)
GRAPHS_CLI = dict(procedural=12, batch_size=8, num_epochs=2,
                  num_inference_steps=2, seed=SEED)
GRAPHS_CLI_STEPS = 4
GRAPHS_CLI_TIMEOUT = 600


def graphs_cli_child(work):
    """`train_refiner --cuda-graphs` at its default widths on GRAPHS_CLI,
    in a process of its own (this script with `--graphs-cli-child`), under
    torch's deterministic mode with cuDNN's deterministic algorithms (two
    eager runs differ without it): once with the step captured, once
    eagerly on the same capturable optimizer (`graphed` patched to hand the
    eager step back). Each checkpoint the CLI saves is taken as a digest
    of the state's bits (`dp_digest`) in place of its file: a refiner
    checkpoint is some GBs, and the card's machine may write 45 GiB a
    call. Writes graphs_cli.json in `work`: each run's logged rows (times
    left out), saved (step, digest) pairs, wall seconds and peak memory."""
    from hifidiff_tpu_torch.cli import train_refiner

    out = {}
    for mode in ("graphs", "eager"):
        saved = []

        class Digests(train_refiner.CheckpointManager):
            def save(self, step, state, extra=None):
                saved.append((step, dp_digest(state)))

        argv = cli_argv(**GRAPHS_CLI, name=mode,
                        log_dir=os.path.join(work, "logs"),
                        ckpt_dir=os.path.join(work, "ckpt"),
                        out_dir=os.path.join(work, "img"), cuda_graphs=True)
        with contextlib.ExitStack() as stack:
            stack.enter_context(deterministic(cudnn=True))
            stack.enter_context(patched(train_refiner, "CheckpointManager",
                                        Digests))
            if mode == "eager":
                stack.enter_context(patched(train_refiner, "graphed",
                                            lambda cfg, step: step))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_refiner.main(argv)
            torch.cuda.synchronize()
        with open(os.path.join(work, "logs",
                               f"hifi_refiner.{mode}.jsonl")) as f:
            rows = [{k: v for k, v in json.loads(line).items()
                     if "time" not in k} for line in f if line.strip()]
        out[mode] = dict(rows=rows, saved=saved,
                         wall_s=time.perf_counter() - t0,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(work, "graphs_cli.json"), "w") as f:
        json.dump(out, f)


def start_graphs_cli(work):
    """`graphs_cli_child` started in `work` beside this process (its output
    into graphs_cli.log there); returns the process."""
    with open(os.path.join(work, "graphs_cli.log"), "w") as out:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--graphs-cli-child",
             work], stdout=out, stderr=subprocess.STDOUT)


def join_graphs_cli(proc, work, smi):
    """Waits for `start_graphs_cli`'s process and prints its output. Fails
    where it failed, where the captured run's logged losses and validation
    metrics are not the eager run's, or where it did not capture the two
    batch shapes once each, or where its saved states' digests are not the
    eager run's."""
    try:
        rc = proc.wait(timeout=GRAPHS_CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    with open(os.path.join(work, "graphs_cli.log")) as f:
        text = f.read()
    log(text.rstrip("\n"))
    path = os.path.join(work, "graphs_cli.json")
    if rc != 0 or not os.path.exists(path):
        fail(f"train_refiner --cuda-graphs: its process ended with rc {rc}")
        return
    with open(path) as f:
        runs = json.load(f)
    graphs, eager = runs["graphs"], runs["eager"]
    steps_ = [r for r in graphs["rows"] if "train_loss" in r]
    log(f"train_refiner --cuda-graphs (batch {GRAPHS_CLI['batch_size']}, "
        f"{len(steps_)} steps, in a process of its own beside phase 13): "
        f"rows {graphs['rows']}; the eager run on the capturable optimizer "
        f"{eager['rows']}; saved states (step, digest) {graphs['saved']} / "
        f"{eager['saved']}; walls {graphs['wall_s']:.1f} / "
        f"{eager['wall_s']:.1f} s, peaks {graphs['peak_gb']:.2f} / "
        f"{eager['peak_gb']:.2f} GB [{smi}]")
    captures = text.count("--cuda-graphs: capturing the train step")
    if graphs["rows"] != eager["rows"] or len(steps_) != GRAPHS_CLI_STEPS \
            or graphs["saved"] != eager["saved"] \
            or len(graphs["saved"]) != GRAPHS_CLI["num_epochs"] \
            or captures != 2:
        fail(f"train_refiner --cuda-graphs: its logged rows or saved states "
             f"are not the eager run's on the capturable optimizer, or it "
             f"captured {captures} times, not once for each batch shape")


def check_training_clis(dev, g, stats, smi, keep, before_refiner=None):
    """Phase 13: the five training stages through their CLIs' `main` at
    their default widths and batches, on the card, chained through their
    checkpoint directories in a temporary directory: `train_vae`,
    `train_cr`, `pretrain_idc --cr-ckpt`, `test_idc` on both stage files,
    `pretrain_denoiser --vae-ckpt` (on images, then on cached latents, with
    and without `--remat`), and `train_refiner` on the four files; each on
    `--procedural` two of its batches, one epoch, so two steps
    (`train_refiner` two epochs). Checked: every logged value finite; every
    step's kernel launches as the module tree gives them; the refiner as
    `train_refiner` composed it holding the stage files' tensors bit for
    bit; the `--remat` run's first loss and gradients against the plain
    run's to phase 8's limits, and a step of it adding less memory;
    `train_refiner` stopped after its first epoch and resumed reaching the
    two epochs' step count and learning rate (these three runs validate
    with 2 sampler steps); every map that reached a kernel in all of it
    against the plain version. `before_refiner()` runs, with the card's
    cache emptied, after the denoiser's runs (the phase's largest) and
    before the refiner's. The stage directories of `train_vae`, `train_cr`
    and the two epochs of `train_refiner` are moved to `keep` (phase 14
    reads them). Returns the numbers by stage."""
    import shutil
    import tempfile

    from hifidiff_tpu_torch.cli import (common, pretrain_denoiser,
                                        pretrain_idc, test_idc, train_cr,
                                        train_refiner, train_vae)
    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.train import checkpoint

    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            recording(training=True) as seen:
        kernels.reset_launches()
        logs = os.path.join(tmp, "logs")

        def ck(stage, name="t"):
            return os.path.join(tmp, "ckpt", stage, name)

        def argv(cli, name="t", **kw):
            return cli_argv(**stage_flags(cli, tmp, name, **kw))

        def stage(label, cli, factories, name="t", **kw):
            result, numbers = run_cli(label, cli, argv(cli, name, **kw),
                                      factories, cli.Config.batch_size, smi)
            out[label] = numbers
            return result

        stage("train_vae", train_vae, ["make_vae_train_step"])
        finite_log("train_vae", logs, "hifi_vae", "t", STAGE_BATCHES)
        stage("train_cr", train_cr, ["make_cr_train_step"])
        finite_log("train_cr", logs, "hifi_cr", "t", STAGE_BATCHES)
        stage("pretrain_idc", pretrain_idc, ["make_idc_train_step"],
              cr_ckpt=ck("train_cr"))
        finite_log("pretrain_idc", logs, "hifi_idc", "t", STAGE_BATCHES)

        # test_idc on the held-out split of pretrain_idc's faces
        n = STAGE_BATCHES * pretrain_idc.Config.batch_size
        batches = math.ceil(max(4, n // 4) / test_idc.Config.batch_size)
        before = dict(kernels.LAUNCHES)
        acc = stage("test_idc", test_idc, [], procedural=n,
                    cr_ckpt=ck("train_cr"), idc_ckpt=ck("pretrain_idc"))
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        want = {"affine_warp": batches
                * out["pretrain_idc"]["launches_per_step"]["affine_warp"]}
        log(f"test_idc: {acc}; launches {launched}, the module tree gives "
            f"{want}")
        if launched != want or not all(0 <= acc[k] <= 1 for k in (
                "batch_accuracy", "sample_accuracy")):
            fail(f"test_idc: {acc}, launches {launched} against {want}")

        # the denoiser: on images (the refiner's stage file), then on
        # cached latents without and with --remat, the same seed
        stage("pretrain_denoiser", pretrain_denoiser,
              ["make_denoiser_train_step"], vae_ckpt=ck("train_vae"))
        finite_log("pretrain_denoiser", logs, "hifi_denoiser", "t",
                   STAGE_BATCHES)
        firsts = {}
        for name, more in (("cached", {}), ("remat", dict(remat=1))):
            store = firsts[name] = {}
            label = "pretrain_denoiser --cache-latents" + (
                " --remat" if more else "")
            with first_step_gradients(store):
                stage(label, pretrain_denoiser,
                      ["make_denoiser_train_step_cached"], name=name,
                      vae_ckpt=ck("train_vae"), cache_latents=1, **more)
            rows = finite_log(f"pretrain_denoiser {name}", logs,
                              "hifi_denoiser", name, STAGE_BATCHES)
            store["loss"] = rows[0]["train_loss"]
            shutil.rmtree(ck("pretrain_denoiser", name))   # read by none
        plain, remat = (out[f"pretrain_denoiser --cache-latents{m}"]
                        for m in ("", " --remat"))
        if train_disagreement("pretrain_denoiser at batch 512: --remat vs "
                              "plain, first step", firsts["remat"],
                              firsts["cached"], 1):
            fail("pretrain_denoiser --remat: the first step's loss or "
                 "gradients differ from the plain run's")
        log(f"pretrain_denoiser at batch 512 on cached latents: a step adds "
            f"{plain['step_peak_gb']:.2f} GB plain and "
            f"{remat['step_peak_gb']:.2f} GB with --remat; steps "
            f"{[round(t, 1) for t in plain['step_ms']]} and "
            f"{[round(t, 1) for t in remat['step_ms']]} ms; the runs peak "
            f"{plain['run_peak_gb']:.2f} and {remat['run_peak_gb']:.2f} GB "
            f"[{smi}]")
        if not remat["step_peak_gb"] < plain["step_peak_gb"]:
            fail("pretrain_denoiser --remat: a step does not add less memory")

        # the refiner over the four stage files for two epochs: the
        # composed refiner against them; then one epoch with
        # --stop-after-epoch and --resume against it
        composed = {}
        real_compose = train_refiner.compose

        def spy(cfg, refiner):
            loaded = real_compose(cfg, refiner)
            composed.update({k: v.detach().cpu().clone()
                             for k, v in refiner.state_dict().items()})
            return loaded

        files = dict(cr_ckpt=ck("train_cr"), idc_ckpt=ck("pretrain_idc"),
                     denoiser_ckpt=ck("pretrain_denoiser"),
                     vae_ckpt=ck("train_vae"))
        if before_refiner is not None:
            torch.cuda.empty_cache()
            before_refiner()

        def final(name, kept=None):
            """The run's last state on the host. Its directory is removed
            (a full-width refiner's state is 5.9 GB a file), or with `kept`
            moved to `keep` holding its last file alone."""
            mgr = checkpoint.CheckpointManager(ck("train_refiner", name),
                                               create=False)
            last = mgr.latest_step()
            state = torch.load(mgr.path(last), map_location="cpu",
                               weights_only=True)
            if kept is None:
                shutil.rmtree(ck("train_refiner", name))
            else:
                for step in mgr.steps():
                    if step != last:
                        os.remove(mgr.path(step))
                shutil.move(ck("train_refiner", name),
                            os.path.join(keep, kept))
            return state["state"]

        resume_runs = dict(num_epochs=2, num_inference_steps=2, **files)
        with patched(train_refiner, "compose", spy):
            stage("train_refiner, two epochs", train_refiner,
                  ["make_refiner_train_step"], name="whole", **resume_runs)
        finite_log("train_refiner", logs, "hifi_refiner", "whole",
                   2 * STAGE_BATCHES)
        held = 0
        for prefix, path in (("idc.", files["idc_ckpt"]),
                             ("denoiser.", files["denoiser_ckpt"])):
            for k, v in common.read_state_dict(path).items():
                held += 1
                if not torch.equal(composed[prefix + k], v):
                    fail(f"train_refiner: the composed {prefix + k} is not "
                         "the stage file's")
        log(f"train_refiner: the composed refiner holds the {held} tensors "
            "of the IDC and denoiser files bit for bit")
        del composed
        whole = final("whole", kept="train_refiner")
        stage("train_refiner, stopped after epoch 0", train_refiner,
              ["make_refiner_train_step"], name="split", stop_after_epoch=0,
              **resume_runs)
        stage("train_refiner, resumed", train_refiner,
              ["make_refiner_train_step"], name="split", resume=1,
              **resume_runs)
        split = final("split")
        lrs = [s["optimizer"]["param_groups"][0]["lr"] for s in (whole,
                                                                  split)]
        far = max(float((whole["module"][k].float()
                         - split["module"][k].float()).abs().max())
                  for k in whole["module"])
        log(f"train_refiner resume: steps {whole['step']} / {split['step']}, "
            f"learning rate {lrs[0]:.6e} / {lrs[1]:.6e}, schedule "
            f"{whole['scheduler']['last_epoch']} / "
            f"{split['scheduler']['last_epoch']}; for the record, the "
            f"parameters differ by at most {far:.3e}")
        if whole["step"] != split["step"] or lrs[0] != lrs[1] \
                or whole["step"] != 2 * STAGE_BATCHES:
            fail("train_refiner: the resumed run did not reach the "
                 "uninterrupted run's step count and learning rate")
        del whole, split
        for kept in ("train_vae", "train_cr"):
            shutil.move(ck(kept), os.path.join(keep, kept))
        shutil.rmtree(os.path.join(tmp, "ckpt"))   # the stage files

        launched = dict(kernels.LAUNCHES)
    for k, n in launched.items():
        if n != sum(seen[k].values()):
            fail(f"phase 13: {k} launched {n} times, the recorded calls "
                 f"{sum(seen[k].values())}")
    log("phase 13 maps (dtype, B, C, H, W) -> calls: "
        + json.dumps({k: {"x".join(map(str, s)): n for s, n in v.items()}
                      for k, v in seen.items() if v}))
    check_recorded_shapes(dev, g, stats, seen)
    return out


# -- phase 14: the perceptual metrics and the distillation trainers --------

def torchvision_state_dict(features, gen):
    """Random weights under torchvision's names for a `features` Sequential
    of `eval/vgg.py` / `eval/lpips.py`: kaiming-normal convolutions (the
    activations keep their scale through the trunk), small biases; drawn
    on the host from the torch.Generator `gen`."""
    sd = {}
    for i, m in enumerate(features):
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            sd[f"features.{i}.weight"] = torch.randn(
                m.weight.shape, generator=gen) * math.sqrt(2.0 / fan_in)
            sd[f"features.{i}.bias"] = 0.05 * torch.randn(m.bias.shape,
                                                          generator=gen)
    return sd


def distill_launches(module, teacher, cr, teacher_calls, student_calls,
                     update=True):
    """The launches of one distillation step that the module tree gives:
    one warp per STN of the frozen CR (no backward), two `ln_film` per
    ConditionalNAFBlock in each of the teacher's `teacher_calls` and the
    student's `student_calls` forwards, and with `update` two
    `ln_film_bwd` per block of the student in each of its calls."""
    blocks = len(module.denoiser.blocks())
    return {"affine_warp": sum(hasattr(m, "fc_loc") for m in cr.modules()),
            "ln_film": 2 * (len(teacher.denoiser.blocks()) * teacher_calls
                            + blocks * student_calls),
            "ln_film_bwd": 2 * blocks * student_calls if update else 0}


def meta_stack(cli, **flags):
    """The CR / VAE / FacialRefiner of a CLI's size flags, built on the meta
    device (no memory, no init): what `expected_launches` counts."""
    from hifidiff_tpu_torch.cli import common

    with torch.device("meta"):
        cr, vae, refiner, _ = common.build_refiner_models(
            cli.Config(**flags))
    return refiner, cr, vae


def check_test_refiner_metrics(dev, tmp, keep, g_host, smi):
    """`test_refiner` at its defaults on the card with the three metric
    flags: a VGG16 and lpips heads drawn at random under torchvision's and
    lpips' names, and a NIQE model that `fit_niqe_model` fits on procedural
    faces, over phase 13's stage files; then one LPIPS call on the card
    against the same call on the host CPU (TF32 off)."""
    from hifidiff_tpu_torch.cli import test_refiner
    from hifidiff_tpu_torch.data.procedural import ProceduralFaceDataset
    from hifidiff_tpu_torch.eval import lpips, niqe
    from hifidiff_tpu_torch.ops import kernels

    vgg16, heads = (os.path.join(tmp, f) for f in ("vgg16.pt",
                                                   "lpips_vgg.pt"))
    torch.save(torchvision_state_dict(lpips.vgg_features(
        lpips.VGG16_STAGES, pool_after_last=True), g_host), vgg16)
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1,
                                                     generator=g_host)
                for i, c in enumerate((64, 128, 256, 512, 512))}, heads)
    t0 = time.perf_counter()
    faces = ProceduralFaceDataset(NIQE_FACES, 128, keys=("gt",),
                                  seed=SEED + 3)
    mu, cov = niqe.fit_niqe_model([faces[i]["gt"] for i in range(len(faces))])
    model = os.path.join(tmp, "niqe.npz")
    np.savez(model, mu=mu, cov=cov)
    log(f"NIQE model fitted on {NIQE_FACES} procedural faces at 128 px on "
        f"the host: {time.perf_counter() - t0:.1f} s")

    files = dict(refiner_ckpt=os.path.join(keep, "train_refiner"),
                 cr_ckpt=os.path.join(keep, "train_cr"),
                 vae_ckpt=os.path.join(keep, "train_vae"))
    per_call = expected_launches(*meta_stack(test_refiner))
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    got = test_refiner.main(cli_argv(
        **files, procedural=EVAL_PROCEDURAL, grid_every=0, seed=SEED,
        vgg16_ckpt=vgg16, lpips_ckpt=heads, niqe_model=model))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: kernels.LAUNCHES[k] - before[k]
                for k in ("ln_film", "affine_warp")}
    want = {k: EVAL_BATCHES * per_call[k] for k in launched}
    log(f"test_refiner on the card with its metric flags (f32, batch 4, "
        f"DDIM-50, {EVAL_BATCHES} batches): {json.dumps(got)}, "
        f"{seconds:.1f} s with the weights' load; kernel launches "
        f"{launched} (the module tree gives {want}) [{smi}]")
    if set(got) != {"psnr", "ssim", "lpips", "niqe"} \
            or not all(np.isfinite(v) for v in got.values()) \
            or launched != want:
        fail(f"test_refiner with its metric flags: {got}, launches "
             f"{launched} against {want}")

    # LPIPS, card against host CPU, on procedural faces against their
    # degraded inputs
    from hifidiff_tpu_torch.cli.common import read_state_dict

    pairs = ProceduralFaceDataset(4, 128, keys=("lr", "gt"), seed=SEED + 4)
    x, y = (torch.from_numpy(np.stack([pairs[i][k] for i in range(4)]))
            .permute(0, 3, 1, 2).contiguous() for k in ("lr", "gt"))
    net, lins = lpips.load_lpips_params(read_state_dict(vgg16),
                                        read_state_dict(heads))
    with torch.no_grad():
        host = lpips.lpips_distance(net, lins, x, y)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            card = lpips.lpips_distance(
                net.to(dev), [w.to(dev) for w in lins], x.to(dev),
                y.to(dev)).cpu()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    rel = float((card - host).abs().max() / host.abs().max())
    log(f"LPIPS (VGG16) of 4 procedural faces against their inputs: card "
        f"{card.tolist()}, host CPU {host.tolist()}: rel {rel:.2e} (limit "
        f"{LPIPS_REL:.0e})")
    if not rel <= LPIPS_REL:
        fail(f"LPIPS on the card: {rel:.2e} from the host CPU's")
    return got


def check_train_cr_vgg(tmp, g_host, smi):
    """`train_cr` at its defaults with the CRLoss and its VGG term
    (`--loss composite --lambda-vgg 0.1 --vgg19-ckpt`, a VGG19 drawn at
    random under torchvision's names), two steps, three runs: through the
    kernels, through their plain versions on the card, and with
    `--lambda-vgg 0`. The first step's loss and gradients of the first run
    against the second's to phase 8's limits (9 warp and 9 warp-backward
    launches a step through the kernels); its gradients against the third
    run's to the same limits, the VGG term adding no gradient; its loss
    above the third run's."""
    from hifidiff_tpu_torch.cli import train_cr
    from hifidiff_tpu_torch.eval import vgg
    from hifidiff_tpu_torch.ops import warp

    vgg19 = os.path.join(tmp, "vgg19.pt")
    torch.save(torchvision_state_dict(vgg.vgg_features(
        ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
        pool_after_last=True), g_host), vgg19)
    out, firsts = {}, {}
    runs = (("vgg", dict(lambda_vgg=0.1, vgg19_ckpt=vgg19), False),
            ("vgg, plain versions", dict(lambda_vgg=0.1, vgg19_ckpt=vgg19),
             True),
            ("no vgg", dict(lambda_vgg=0.0), False))
    for name, more, plain in runs:
        store = firsts[name] = {}
        label = f"train_cr --loss composite ({name})"
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(patched(warp, "warp", warp.warp_plain))
                stack.enter_context(patched(warp, "warp_bwd",
                                            warp.warp_bwd_plain))
            stack.enter_context(first_step_gradients(store))
            _, out[label] = run_cli(
                label, train_cr, cli_argv(
                    **stage_flags(train_cr, tmp, name.replace(" ", "_")
                                  .replace(",", "")),
                    loss="composite", dump_every=0, **more),
                ["make_cr_train_step"], train_cr.Config.batch_size, smi,
                expected=(lambda *a: {}) if plain else default_expected)
        rows = finite_log(label, os.path.join(tmp, "logs"), "hifi_cr",
                          name.replace(" ", "_").replace(",", ""),
                          STAGE_BATCHES)
        store["loss"] = rows[0]["train_loss"]
    vgg_run = firsts["vgg"]
    if train_disagreement("train_cr with the VGG term: kernels vs plain "
                          "versions on the card, first step", vgg_run,
                          firsts["vgg, plain versions"], 1):
        fail("train_cr with the VGG term: the kernels' run and the plain "
             "versions' disagree")
    no_vgg = firsts["no vgg"]
    if train_disagreement("train_cr: gradients with the VGG term vs "
                          "without (the loss of the run without)",
                          dict(vgg_run, loss=no_vgg["loss"]), no_vgg, 1):
        fail("train_cr: the VGG term changed the gradients")
    log(f"train_cr first loss with the VGG term {vgg_run['loss']:.6f}, "
        f"without {no_vgg['loss']:.6f}")
    if not vgg_run["loss"] > no_vgg["loss"]:
        fail("train_cr: the VGG term added nothing to the loss")
    return out


def stage_flags(cli, tmp, name, **more):
    """The flags phases 13 and 14 give a stage: STAGE_BATCHES of the CLI's
    default batch of procedural faces, one epoch, and its run `name`, logs,
    checkpoints (`tmp/ckpt/<stage>/<name>`) and images under `tmp`, where
    the CLI has those fields; `more` on top."""
    stage = cli.__name__.rsplit(".", 1)[1]
    fields = {f.name for f in dataclasses.fields(cli.Config)}
    kw = {"procedural": STAGE_BATCHES * cli.Config.batch_size, "seed": SEED,
          "num_epochs": 1, "name": name,
          "log_dir": os.path.join(tmp, "logs"),
          "ckpt_dir": os.path.join(tmp, "ckpt", stage),
          "out_dir": os.path.join(tmp, "img", stage)}
    return {**{k: v for k, v in kw.items()
               if k in fields or k == "procedural"}, **more}


def cli_argv(**kw):
    return [a for k, v in kw.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def check_distill_clis(tmp, keep, smi):
    """The four distillation CLIs at their default widths and batches, two
    steps each, eager, on phase 13's stage files: `train_tae --vae-ckpt`
    (batch 64), `train_tiny_cr --cr-ckpt` (64), `train_tiny_dn` (16, its
    validation pass counted apart) and `distill` (16, 50 -> 10 steps, 5
    sub-steps) on the refiner, CR and VAE files. Every step's launches as
    the module tree gives them (`distill_launches`); then the distilled
    student, the tiny denoiser and the two tiny seams through
    `test_refiner` for one sampler call each (10 steps), finite and with
    their launches."""
    from hifidiff_tpu_torch.cli import (distill, test_refiner, train_tae,
                                        train_tiny_cr, train_tiny_dn)
    from hifidiff_tpu_torch.ops import kernels

    out = {}
    files = dict(refiner_ckpt=os.path.join(keep, "train_refiner"),
                 cr_ckpt=os.path.join(keep, "train_cr"),
                 vae_ckpt=os.path.join(keep, "train_vae"))
    rollout = train_tiny_dn.Config.rollout_steps
    substeps = distill.Config.teacher_steps // int(distill.Config
                                                   .student_steps)
    stages = (
        ("train_tae", train_tae, "make_tae_train_step", "hifi_tae",
         dict(vae_ckpt=files["vae_ckpt"]), default_expected),
        ("train_tiny_cr", train_tiny_cr, "make_tiny_cr_train_step",
         "hifi_tiny_cr", dict(cr_ckpt=files["cr_ckpt"]), default_expected),
        ("train_tiny_dn", train_tiny_dn, "make_tiny_dn_train_step",
         "hifi_tiny_dn", files,
         lambda module, cr, a, k: distill_launches(
             module, a[0], cr, rollout + 1, 2, k.get("update", True))),
        ("distill", distill, "make_distill_train_step", "hifi_distill",
         dict(files, steps_per_round=STAGE_BATCHES,
              procedural=DISTILL_PROCEDURAL),
         lambda module, cr, a, k: distill_launches(module, a[0], cr,
                                                   substeps, 1)))
    for label, cli, factory, project, more, expected in stages:
        result, out[label] = run_cli(
            label, cli, cli_argv(**stage_flags(cli, tmp, "t", **more)),
            [factory], cli.Config.batch_size, smi, expected=expected)
        rows = [r for r in finite_log(label, os.path.join(tmp, "logs"),
                                      project, "t", 0 if label == "distill"
                                      else STAGE_BATCHES)]
        if out[label]["steps"] != STAGE_BATCHES:
            fail(f"{label}: {out[label]['steps']} steps, not "
                 f"{STAGE_BATCHES}")
        if label == "distill":
            log(f"distill: {json.dumps(result)} [{smi}]")
            if not all(np.isfinite(v) for r in result["rounds"]
                       for v in r.values()) or not rows:
                fail(f"distill: {result}")

    # the students and the seams in the split sampler, one call each
    ck = os.path.join(tmp, "ckpt")
    calls = (
        ("the distilled student",
         dict(refiner_ckpt=os.path.join(ck, "distill", "t", "round0_s10")),
         {}),
        ("the tiny denoiser", dict(
            refiner_ckpt=os.path.join(ck, "train_tiny_dn", "t"),
            width=train_tiny_dn.Config.tiny_width),
         dict(width=train_tiny_dn.Config.tiny_width)),
        ("the tiny autoencoder and the tiny CR", dict(
            refiner_ckpt=files["refiner_ckpt"],
            tae_ckpt=os.path.join(ck, "train_tae", "t"),
            tiny_cr_ckpt=os.path.join(ck, "train_tiny_cr", "t")),
         {}))
    steps = distill.Config.student_steps
    for what, flags, sizes in calls:
        refiner, cr, vae = meta_stack(test_refiner, **sizes)
        per_step = expected_launches(refiner, cr, vae)
        want = {"ln_film": per_step["ln_film"] // STEPS * int(steps),
                "affine_warp": 0 if "tiny_cr_ckpt" in flags
                else per_step["affine_warp"]}
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = test_refiner.main(cli_argv(
            **dict(files, **flags), procedural=16, grid_every=0, seed=SEED,
            num_inference_steps=steps))
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in want}
        log(f"split sampler with {what}: {json.dumps(got)}, one call of "
            f"{steps} steps at batch 4, {time.perf_counter() - t0:.1f} s "
            f"with the load; launches {launched} (the module tree gives "
            f"{want})")
        if not all(np.isfinite(v) for v in got.values()) or launched != want:
            fail(f"split sampler with {what}: {got}, launches {launched} "
                 f"against {want}")
    return out


def check_eval_and_distillation(dev, g, stats, smi, keep):
    """Phase 14: `test_refiner`'s metric flags, `train_cr`'s VGG term and the
    four distillation CLIs on the card at their default widths, in a
    temporary directory, on the stage files phase 13 kept in `keep`; the
    launch counts set to 0 before and read after, held to the shapes
    recorded, and every map that reached `ln_film`, `ln_film_bwd`, the warp
    or its backward held to the plain version (twice, for equal bits).
    Returns the numbers by stage, and the launches of each kernel by
    stage's first step."""
    import tempfile

    from hifidiff_tpu_torch.ops import kernels

    g_host = torch.Generator().manual_seed(SEED + 14)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            recording(training=True) as seen:
        kernels.reset_launches()
        out["test_refiner metrics"] = check_test_refiner_metrics(
            dev, tmp, keep, g_host, smi)
        out.update(check_train_cr_vgg(tmp, g_host, smi))
        out.update(check_distill_clis(tmp, keep, smi))
        launched = dict(kernels.LAUNCHES)
    for k, n in launched.items():
        if n != sum(seen[k].values()):
            fail(f"phase 14: {k} launched {n} times, the recorded calls "
                 f"{sum(seen[k].values())}")
    log("phase 14 maps (dtype, B, C, H, W) -> calls: "
        + json.dumps({k: {"x".join(map(str, s)): n for s, n in v.items()}
                      for k, v in seen.items() if v}))
    check_recorded_shapes(dev, g, stats, seen, "phase 14")
    per_step = {label: n["launches_per_step"] for label, n in out.items()
                if isinstance(n, dict) and "launches_per_step" in n}
    return out, per_step


# -- phase 15: the PNG data path ----------------------------------------------

MP_ANGLES = ("11_0", "12_0", "09_0", "19_1", "08_1", "20_0", "01_0", "24_0",
             "08_0", "13_0", "14_0", "05_0", "04_1", "19_0", "05_1")
MP_PIDS = 4
MP_SIDE = 160
CELEBA_SIDE = 256
# with the 56 images of the Multi-PIE train split, two batches of 512 for
# pretrain_denoiser (phase 13's batch and step count)
CELEBA_FACES = 968
CELEBA_LOOKS = 64


def write_png_trees(root):
    """A Multi-PIE tree (`train/` and `test/`, MP_PIDS pids each, the 15
    angles, lights 00 and 01, `_patch.png` on 05_1) of MP_SIDE^2 procedural
    faces written by `png_filtered` (rows through the five filters in
    turn, colour type 2), and a flat CelebA-HQ directory of CELEBA_FACES
    CELEBA_SIDE^2 ones in the formats of `celeba_file` in turn (since
    phase 19); the first pid's 00 files at the first two angles of
    `train/` are the CMYK JPEG and the lossless animated WebP fixtures of
    tests/fixtures (MP_SIDE^2 faces, read by content whatever the name).
    Returns (Multi-PIE root, CelebA root, files, bytes)."""
    from hifidiff_tpu_torch.data import procedural as proc

    mp, celeba = os.path.join(root, "multipie"), os.path.join(root, "celeba")
    written = [0, 0]

    def put(path, img):
        data = img if isinstance(img, bytes) else png_filtered(img, level=1)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        written[0] += 1
        written[1] += len(data)

    def u8(face):
        return (np.clip(face, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    def fixture(sub, name):
        with open(os.path.join(FIXTURES, sub, name), "rb") as f:
            return f.read()

    cmyk = fixture("jpeg", CELEBA_CMYK)
    replaced = {("train", 0, MP_ANGLES[0]): cmyk,
                ("train", 0, MP_ANGLES[1]): fixture(
                    "webp", "anim_lossless_face_160x160.webp")}
    for split, first in (("train", 0), ("test", MP_PIDS)):
        for p in range(MP_PIDS):
            idp = proc._identity_params(SEED, first + p)
            for a, angle in enumerate(MP_ANGLES):
                pose = 0.0 if angle == "05_1" else -0.8 + 1.6 * a / 13
                face = proc.render_face(idp, pose, MP_SIDE)
                for light, gain in (("00", 1.0), ("01", 0.8)):
                    d = os.path.join(mp, split, f"{p:03d}", angle)
                    put(os.path.join(d, f"{light}.png"),
                        replaced.get((split, p, angle), u8(face * gain))
                        if light == "00" else u8(face * gain))
                    if angle == "05_1":
                        patch = np.zeros_like(face)
                        for t, le, b, r in proc.component_boxes(idp,
                                                                MP_SIDE):
                            patch[t:b, le:r] = face[t:b, le:r]
                        put(os.path.join(d, f"{light}_patch.png"),
                            u8(patch * gain))
    looks = [u8(proc.render_face(proc._identity_params(SEED + 1, j),
                                 -0.5 + j / CELEBA_LOOKS, CELEBA_SIDE))
             for j in range(CELEBA_LOOKS)]
    with open(os.path.join(JPEG_FIXTURES, CELEBA_PROGRESSIVE), "rb") as f:
        progressive = f.read()
    webps = []
    for name in CELEBA_WEBP:
        with open(os.path.join(FIXTURES, "webp", name), "rb") as f:
            webps.append(f.read())
    for j in range(CELEBA_FACES):
        img = looks[j % CELEBA_LOOKS]
        img = np.roll(img, j // CELEBA_LOOKS, axis=1)   # a file of its own
        data, ext = celeba_file(img, j, progressive, webps, cmyk)
        put(os.path.join(celeba, f"{j:05d}{ext}"), data)
    return mp, celeba, written[0], written[1]


def time_decodes(smi):
    """`imread_rgb` on the host, through the host library, beside the plain
    decoder (`decode_png_plain`) on the same bytes: ms per file for a
    MP_SIDE^2 and a CELEBA_SIDE^2 face and for 640 x 480 (Multi-PIE's
    uncropped frame), rows through the five filters in turn, and the 640 x
    480 frame with every row Sub (cv2's choice when it writes a PNG) and
    every row Paeth. Returns {label: {"ms", "plain_ms"}}."""
    import tempfile

    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data.image_io import decode_png_plain, imread_rgb

    idp = proc._identity_params(SEED, 0)
    small = (proc.render_face(idp, 0.3, MP_SIDE) * 255).astype(np.uint8)
    mid = (proc.render_face(idp, 0.3, CELEBA_SIDE) * 255).astype(np.uint8)
    frame = (proc.render_face(idp, 0.3, 640)[80:560] * 255).astype(np.uint8)
    frame = np.ascontiguousarray(frame)
    cases = {f"{MP_SIDE}x{MP_SIDE}, the five filters in turn": (small, None),
             f"{CELEBA_SIDE}x{CELEBA_SIDE}, the five filters in turn":
                 (mid, None),
             "640x480, the five filters in turn": (frame, None),
             "640x480, Sub rows only": (frame, (1,)),
             "640x480, Paeth rows only": (frame, (4,))}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (img, filters) in cases.items():
            path = os.path.join(tmp, "x.png")
            data = png_filtered(img, filters or (0, 1, 2, 3, 4))
            with open(path, "wb") as f:
                f.write(data)
            if not np.array_equal(imread_rgb(path), img) or not \
                    np.array_equal(decode_png_plain(data), img):
                fail(f"imread_rgb: {label} does not read back bit for bit")
            out[label] = dict(ms=median_ms(lambda: imread_rgb(path), 11),
                              plain_ms=median_ms(
                                  lambda: decode_png_plain(data), 3))
            log(f"imread_rgb on the host, {label}: {out[label]['ms']:.3f} "
                f"ms a file through the host library, "
                f"{out[label]['plain_ms']:.2f} ms plain [{smi}]")
    return out


@contextlib.contextmanager
def timed_loader(cli, waits=None, train_batches=None, eval_batches=None):
    """`data.core.Loader` (and `cli.Loader` where the CLI imported it by
    name) made to add, for its shuffled (training) loaders, (k, seconds)
    to `waits` for the k-th batch of each pass, the seconds the consumer
    waited for it, and, where given, to give at most `train_batches`
    batches when shuffled and `eval_batches` otherwise."""
    from hifidiff_tpu_torch.data import core

    real = core.Loader

    class Timed(real):
        def _limit(self):
            limit = train_batches if self.shuffle else eval_batches
            return len(self.dataset) if limit is None else limit

        def _batch_indices(self):
            return super()._batch_indices()[:self._limit()]

        def __len__(self):
            return min(super().__len__(), self._limit())

        def __iter__(self):
            batches = super().__iter__()
            for k in range(len(self) + 1):
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                if self.shuffle and waits is not None:
                    waits.append((k, time.perf_counter() - t0))
                yield batch

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(core, "Loader", Timed))
        if getattr(cli, "Loader", None) is real:
            stack.enter_context(patched(cli, "Loader", Timed))
        yield


def loader_waits(label, numbers, waits, smi, how=""):
    """Adds to `numbers` the loader's wait from `timed_loader`'s `waits`:
    in all, for the first batch of each pass (built by one thread while
    the others start) and for the other batches, and in all as a share of
    the steps' wall; logs them."""
    step_s = sum(numbers["step_ms"]) / 1e3
    total = sum(t for _, t in waits)
    first = sum(t for k, t in waits if k == 0)
    numbers.update(loader_wait_s=total, first_batch_wait_s=first,
                   other_batches_wait_s=total - first,
                   loader_wait_share=total / max(total + step_s, 1e-9))
    firsts = sum(k == 0 for k, _ in waits)
    log(f"{label}: {numbers['steps']} steps{how}; the training loop waited "
        f"{total:.2f} s for its {len(waits)} batches ({first:.2f} s for the "
        f"first batch of each of its {firsts} passes, {total - first:.2f} s "
        f"for the other {len(waits) - firsts}) against {step_s:.2f} s in "
        f"the steps: the loader's wait is "
        f"{numbers['loader_wait_share']:.3f} of the steps' wall "
        f"({numbers['wall_s']:.1f} s for the stage) [{smi}]")


def check_infer_cr(dev, tmp, keep, smi, image=None, dataroot=None):
    """`infer_cr` at its defaults (width 32, depths 2,2,4,8, mid 8, size
    128, batch 8) on phase 13's `train_cr` directory, on one image
    (`--image`) or on a K-Face tree (`--dataroot`, its val split, the
    caller's loader cut to one batch): on the host CPU and on the card (f32,
    TF32 off); the restored faces within LATENT_REL_TOL of their scale and
    the saved grids within FACE_LEVEL_TOL; on the card 9 warp launches a
    CR call, the module tree's."""
    from hifidiff_tpu_torch.cli import infer_cr
    from hifidiff_tpu_torch.data.image_io import imread_rgb
    from hifidiff_tpu_torch.ops import kernels

    source = ["--image", image] if image else ["--dataroot", dataroot]
    argv = source + ["--ckpt", os.path.join(keep, "train_cr")]

    def grid(where):
        return (os.path.join(tmp, f"{where}.png") if image
                else os.path.join(tmp, where, "batch_0.png"))

    def flags(where):
        return ["--output", grid(where), "--out-dir",
                os.path.join(tmp, where)]

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        host = infer_cr.main(argv + ["--device", "cpu"] + flags("host"))
        host_s = time.perf_counter() - t0
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        card = infer_cr.main(argv + flags("card"))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before
                if kernels.LAUNCHES[k] != before[k]}
    cfg = infer_cr.Config()
    with torch.device("meta"):
        cr = infer_cr.build_cr(cfg.width, cfg.size, cfg.enc_depths,
                               cfg.mid_depth)
    stns = sum(hasattr(m, "fc_loc") for m in cr.modules())
    calls = 1 if image else math.ceil(len(card) / cfg.batch_size)
    want = {"affine_warp": stns * calls}
    rel = float(np.abs(card - host).max() / max(np.abs(host).max(), 1e-12))
    grids = [imread_rgb(grid(w)).astype(int) for w in ("card", "host")]
    levels = int(np.abs(grids[0] - grids[1]).max())
    what = "one image" if image else "the K-Face val split"
    log(f"infer_cr at its defaults on the train_cr directory, {what} "
        f"({len(card)} faces, {calls} CR calls): card {card_s:.2f} s, host "
        f"CPU {host_s:.2f} s (each with the load); card vs host "
        f"{rel:.3e} of the face's scale (limit {LATENT_REL_TOL}), saved "
        f"grids {levels} levels apart (limit {FACE_LEVEL_TOL}); launches "
        f"{launched}, the module tree gives {want} [{smi}]")
    if card.shape[1:] != (cfg.size, cfg.size, 3) or not len(card) \
            or card.shape != host.shape or not np.isfinite(card).all() \
            or rel > LATENT_REL_TOL or levels > FACE_LEVEL_TOL \
            or launched != want or stns != 9:
        fail(f"infer_cr on {what}: card vs host {rel:.3e}, grids {levels} "
             f"levels, launches {launched} against {want}")
    return dict(card_s=card_s, host_s=host_s, rel_err=rel, levels=levels,
                launches=launched, faces=len(card))


def check_png_data_path(dev, g, stats, smi, keep, tmp):
    """Phase 15: the PNG data path on the card, on image trees written in
    `tmp` (`write_png_trees`; phase 16 reads the Multi-PIE tree again), with
    phase 13's stage files in `keep`: the decoder's host times
    (`time_decodes`); `infer_cr` (`check_infer_cr`); `pretrain_idc
    --dataroot` (batch 24, one epoch), `pretrain_denoiser --multipie-root
    --celeba-root` (batch 512, one epoch: two steps) and `train_tae
    --multipie-root` (batch 64, two epochs), every step's launches held to
    the module tree, the loader's wait timed as a share of the steps' wall;
    every map that reached a kernel held to its plain version (twice, for
    equal bits). Returns the numbers by stage, the Multi-PIE root under
    "multipie_root"."""
    from hifidiff_tpu_torch.cli import pretrain_denoiser, pretrain_idc
    from hifidiff_tpu_torch.cli import train_tae
    from hifidiff_tpu_torch.data import procedural
    from hifidiff_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    out = {"lr_resize": procedural.LR_RESIZE}
    log(f"phase 15: the procedural faces' LR protocol resizes with "
        f"{procedural.LR_RESIZE}")
    t0 = time.perf_counter()
    mp, celeba, files, nbytes = write_png_trees(tmp)
    out["multipie_root"], out["celeba_root"] = mp, celeba
    log(f"phase 15: {files} image files ({nbytes / 1e6:.1f} MB) written "
        f"in {time.perf_counter() - t0:.1f} s")
    out["decode_ms"] = time_decodes(smi)
    out["infer_cr"] = check_infer_cr(
        dev, tmp, keep, smi,
        image=os.path.join(mp, "test", "000", "19_1", "00.png"))
    with recording(training=True) as seen:
        kernels.reset_launches()
        stages = (
            ("pretrain_idc --dataroot", pretrain_idc,
             "make_idc_train_step", "hifi_idc",
             dict(dataroot=mp, cr_ckpt=os.path.join(keep, "train_cr"))),
            ("pretrain_denoiser --multipie-root --celeba-root",
             pretrain_denoiser, "make_denoiser_train_step",
             "hifi_denoiser",
             dict(multipie_root=mp, celeba_root=celeba,
                  vae_ckpt=os.path.join(keep, "train_vae"))),
            ("train_tae --multipie-root", train_tae,
             "make_tae_train_step", "hifi_tae",
             dict(multipie_root=mp, num_epochs=2,
                  vae_ckpt=os.path.join(keep, "train_vae"))))
        for label, cli, factory, project, more in stages:
            flags = stage_flags(cli, tmp, "t", **more)
            del flags["procedural"]
            waits = []
            with timed_loader(cli, waits):
                _, numbers = run_cli(label, cli, cli_argv(**flags),
                                     [factory], cli.Config.batch_size,
                                     smi)
            rows = finite_log(label, os.path.join(tmp, "logs"), project,
                              "t", numbers["steps"])
            loader_waits(label, numbers, waits, smi)
            if numbers["steps"] < 2 or not rows:
                fail(f"{label}: {numbers['steps']} steps")
            out[label] = numbers
        launched = dict(kernels.LAUNCHES)
    for k, n in launched.items():
        if n != sum(seen[k].values()):
            fail(f"phase 15: {k} launched {n} times, the recorded calls "
                 f"{sum(seen[k].values())}")
    log("phase 15 maps (dtype, B, C, H, W) -> calls: "
        + json.dumps({k: {"x".join(map(str, s)): n for s, n in v.items()}
                      for k, v in seen.items() if v}))
    check_recorded_shapes(dev, g, stats, seen, "phase 15")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['wall_s']:.1f} s wall [{smi}]")
    return out



# -- phase 16: the JPEG codec slice ------------------------------------------

JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "fixtures", "jpeg")
KF_SIDE = 160
KF_QUALITY = 95
# val: test_refiner's and infer_cr's split; test: test_idc's, 10 ids the
# fewest for which KFaceIDCDataset's 19-id window yields items
KF_IDS = {"val": 2, "test": 10}
KF_LIGHTS = ("L1", "L3")
KF_EXPRESSIONS = ("E01", "E02", "E03")
KF_ANGLES = 20
KF_FRONTAL = 7
# head boxes (left, top, width, height): most inside the image; angle 1's
# runs past the left and top edges, angle 20's past the right and bottom
KF_HEAD = (8, 8, 144, 144)
KF_HEAD_PAST = {1: (-6, -4, 150, 150), 20: (20, 16, 150, 150)}
# phase 16's runs, cut to these batches
P16_STEPS = {"train_cr": 2, "train_refiner": 2, "train_tiny_cr": 1,
             "train_tiny_dn": 1, "distill": 1}
P16_EVAL_BATCHES = 1
P16_IDC_BATCHES = 2
ROUNDTRIP_SIDES = (16, 32, 64, 128)


def sha256_hex(data):
    import hashlib

    return hashlib.sha256(data).hexdigest()


def check_golden(smi):
    """The port's codec against tests/fixtures/jpeg/digests.json: every
    golden file decoded to the SHA-256 of cv2's and PIL's RGB, each
    four-component one by each reader to that library's, the refused
    files refused naming what they are (the four-component ones without
    a reader), a golden file cut short refused as truncated, and every
    seeded input encoded to the SHA-256 of cv2.imencode's bytes. Returns
    the counts checked."""
    from hifidiff_tpu_torch.data.jpeg import JPEGError, decode_jpeg, \
        encode_jpeg

    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        golden = json.load(f)
    bad = []

    def read(name):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            return f.read()

    for name, want in golden["decode"].items():
        rgb = decode_jpeg(read(name))
        if list(rgb.shape) != want["shape"] \
                or sha256_hex(rgb.tobytes()) != want["sha256"]:
            bad.append(f"decode {name}")
    for name, by_how in golden["decode_by_reader"].items():
        for how, want in by_how.items():
            rgb = decode_jpeg(read(name), how)
            if list(rgb.shape) != want["shape"] \
                    or sha256_hex(rgb.tobytes()) != want["sha256"]:
                bad.append(f"decode {name} ({how})")
    refusals = dict(golden["refuse"])
    refusals.update({name: "pass reader='cv2' or 'pil'"
                     for name in golden["decode_by_reader"]})
    first = next(iter(golden["decode"]))
    cases = [(name, read(name), what) for name, what in refusals.items()]
    cases.append((f"{first} cut short", read(first)[:-40], "truncated"))
    for name, data, what in cases:
        try:
            decode_jpeg(data)
            bad.append(f"{name} decoded")
        except JPEGError as e:
            if what not in str(e):
                bad.append(f"{name}: {e}")
    for e in golden["encode"]:
        data = encode_jpeg(golden_input(e["seed"], e["height"], e["width"]),
                           e["quality"])
        if sha256_hex(data) != e["sha256"]:
            bad.append(f"encode seed {e['seed']} {e['height']}x"
                       f"{e['width']} q {e['quality']}")
    n = dict(decoded=len(golden["decode"]),
             by_reader=2 * len(golden["decode_by_reader"]),
             refused=len(cases), encoded=len(golden["encode"]))
    log(f"phase 16: golden JPEG digests: {n['decoded']} files decoded, "
        f"{n['by_reader']} four-component decodes by reader, "
        f"{n['refused']} refused, {n['encoded']} seeded inputs encoded; "
        f"mismatches: {bad or 'none'} [{smi}]")
    if bad:
        fail(f"the JPEG codec disagrees with the golden digests: {bad}")
    return n


def write_kface_tree(root):
    """A K-Face tree of procedural faces under `root/kface`: the splits of
    KF_IDS, lights L1 and L3, expressions E01-E03 (the face shifted by 0-2
    columns), angles C1-C20 with C7 frontal, KF_SIDE^2, written by the
    port's encoder (4:2:0, quality KF_QUALITY), each with its `.txt`
    metadata (7 filler lines, the head box, the four component boxes,
    tab-separated `left top width height`). Returns (root, files,
    bytes)."""
    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data.jpeg import encode_jpeg

    kf = os.path.join(root, "kface")
    written = [0, 0]
    first = 0
    for split, ids in KF_IDS.items():
        for i in range(ids):
            idp = proc._identity_params(SEED + 16, first + i)
            comps = ["\t".join(map(str, (le, t, r - le, b - t)))
                     for t, le, b, r in proc.component_boxes(idp, KF_SIDE)]
            for angle in range(1, KF_ANGLES + 1):
                pose = 0.0 if angle == KF_FRONTAL \
                    else -0.8 + 1.6 * (angle - 1) / (KF_ANGLES - 1)
                face = proc.render_face(idp, pose, KF_SIDE)
                head = KF_HEAD_PAST.get(angle, KF_HEAD)
                meta = "\n".join(["x"] * 7 + ["\t".join(map(str, head))]
                                 + comps)
                for light, gain in zip(KF_LIGHTS, (1.0, 0.8)):
                    for e, expr in enumerate(KF_EXPRESSIONS):
                        d = os.path.join(kf, split, f"{split}{i:02d}",
                                         "S001", light, expr)
                        os.makedirs(d, exist_ok=True)
                        img = (np.clip(np.roll(face * gain, e, axis=1), 0,
                                       1) * 255 + 0.5).astype(np.uint8)
                        data = encode_jpeg(img, KF_QUALITY)
                        with open(os.path.join(d, f"C{angle}.jpg"),
                                  "wb") as f:
                            f.write(data)
                        with open(os.path.join(d, f"C{angle}.txt"),
                                  "w") as f:
                            f.write(meta)
                        written[0] += 1
                        written[1] += len(data)
        first += ids
    return kf, written[0], written[1]


def time_codec(smi, kf):
    """The codec and the blind branch on the host: decode ms a file (a
    KF_SIDE^2 K-Face file, and a 1920 x 1080 frame at KF_QUALITY), encode
    ms a file, `jpeg_roundtrip` ms at ROUNDTRIP_SIDES, `blind_degrade` ms
    an item (a KF_SIDE^2 face to 128) on the default and the native path.
    Returns {label: ms}."""
    from hifidiff_tpu_torch.data import degradations, procedural as proc
    from hifidiff_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    path = os.path.join(kf, "val", "val00", "S001", "L1", "E01", "C7.jpg")
    with open(path, "rb") as f:
        small = f.read()
    face = decode_jpeg(small)
    frame = proc.render_face(proc._identity_params(SEED, 0), 0.3, 640)
    frame = (np.tile(frame, (2, 3, 1))[:1080, :1920] * 255).astype(np.uint8)
    big = encode_jpeg(np.ascontiguousarray(frame), KF_QUALITY)
    out = {f"decode {KF_SIDE}x{KF_SIDE}": median_ms(
               lambda: decode_jpeg(small), 21),
           "decode 1920x1080": median_ms(lambda: decode_jpeg(big), 5),
           f"encode {KF_SIDE}x{KF_SIDE}": median_ms(
               lambda: encode_jpeg(face, KF_QUALITY), 21)}
    img = face.astype(np.float32) / 255.0
    for side in ROUNDTRIP_SIDES:
        x = np.ascontiguousarray(img[:side, :side])
        rng = np.random.default_rng(SEED)
        out[f"jpeg_roundtrip {side}x{side}"] = median_ms(
            lambda: degradations.jpeg_roundtrip(rng, x), 21)
    for native in (False, True):
        rng = np.random.default_rng(SEED)
        out[f"blind_degrade, {'native' if native else 'default'} path"] = \
            median_ms(lambda: degradations.blind_degrade(
                rng, img, 128, native=native), 11)
    for label, ms in out.items():
        log(f"phase 16 on the host: {label}: {ms:.3f} ms [{smi}]")
    log(f"phase 16: the 1920x1080 frame is {len(big)} bytes at quality "
        f"{KF_QUALITY}")
    return out


def run_blind_clis(tmp, keep, mp, smi):
    """The five training CLIs whose `--dataroot` takes the blind branch,
    at their defaults on the card, on phase 15's Multi-PIE tree and phase
    13's stage files, cut to P16_STEPS steps and P16_EVAL_BATCHES
    validation batches: every step's launches held to the module tree, the
    loader's wait as a share of the steps' wall. Returns the numbers by
    stage."""
    from hifidiff_tpu_torch.cli import (distill, train_cr, train_refiner,
                                        train_tiny_cr, train_tiny_dn)

    files = dict(refiner_ckpt=os.path.join(keep, "train_refiner"),
                 cr_ckpt=os.path.join(keep, "train_cr"),
                 vae_ckpt=os.path.join(keep, "train_vae"))
    rollout = train_tiny_dn.Config.rollout_steps
    substeps = distill.Config.teacher_steps // int(distill.Config
                                                   .student_steps)
    stages = (
        ("train_cr", train_cr, "make_cr_train_step", "hifi_cr", {},
         default_expected),
        ("train_refiner", train_refiner, "make_refiner_train_step",
         "hifi_refiner", dict(cr_ckpt=files["cr_ckpt"],
                              vae_ckpt=files["vae_ckpt"]),
         default_expected),
        ("train_tiny_cr", train_tiny_cr, "make_tiny_cr_train_step",
         "hifi_tiny_cr", dict(cr_ckpt=files["cr_ckpt"]), default_expected),
        ("train_tiny_dn", train_tiny_dn, "make_tiny_dn_train_step",
         "hifi_tiny_dn", files,
         lambda module, cr, a, k: distill_launches(
             module, a[0], cr, rollout + 1, 2, k.get("update", True))),
        ("distill", distill, "make_distill_train_step", "hifi_distill",
         dict(files, steps_per_round=P16_STEPS["distill"]),
         lambda module, cr, a, k: distill_launches(module, a[0], cr,
                                                   substeps, 1)))
    out = {}
    for name, cli, factory, project, more, expected in stages:
        label = f"{name} --dataroot"
        flags = stage_flags(cli, tmp, "p16", dataroot=mp, **more)
        del flags["procedural"]
        waits = []
        with timed_loader(cli, waits, P16_STEPS[name], P16_EVAL_BATCHES):
            _, numbers = run_cli(label, cli, cli_argv(**flags), [factory],
                                 cli.Config.batch_size, smi,
                                 expected=expected)
        rows = finite_log(label, os.path.join(tmp, "logs"), project, "p16",
                          0 if name == "distill" else numbers["steps"])
        loader_waits(label, numbers, waits, smi,
                     f" at batch {cli.Config.batch_size} through the blind "
                     "branch")
        if numbers["steps"] != P16_STEPS[name] or not rows:
            fail(f"{label}: {numbers['steps']} steps, not "
                 f"{P16_STEPS[name]}")
        out[label] = numbers
    return out


def run_kface_clis(tmp, keep, kf, smi):
    """`test_refiner --dataroot` (the K-Face val split, one sampler call at
    its defaults) and `test_idc --dataroot` (the test split's IDC triplets,
    P16_IDC_BATCHES batches) on the card on phase 13's stage files, their
    launches held to the module tree. Returns their numbers."""
    from hifidiff_tpu_torch.cli import test_idc, test_refiner
    from hifidiff_tpu_torch.ops import kernels

    files = dict(refiner_ckpt=os.path.join(keep, "train_refiner"),
                 cr_ckpt=os.path.join(keep, "train_cr"),
                 vae_ckpt=os.path.join(keep, "train_vae"))
    out = {}
    refiner, cr, vae = meta_stack(test_refiner)
    per_call = expected_launches(refiner, cr, vae)
    steps = test_refiner.Config.num_inference_steps
    want = {"ln_film": per_call["ln_film"] // STEPS * steps,
            "affine_warp": per_call["affine_warp"]}
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with timed_loader(test_refiner, None, 0, P16_EVAL_BATCHES):
        got = test_refiner.main(cli_argv(
            **files, dataroot=kf, grid_every=0, seed=SEED,
            out_dir=os.path.join(tmp, "img", "test_refiner")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in want}
    log(f"test_refiner --dataroot (K-Face val, one call of {steps} steps at "
        f"batch {test_refiner.Config.batch_size}): {json.dumps(got)}, "
        f"{wall:.1f} s with the load; launches {launched}, the module tree "
        f"gives {want} [{smi}]")
    if not got or not all(np.isfinite(v) for v in got.values()) \
            or launched != want:
        fail(f"test_refiner --dataroot: {got}, launches {launched} against "
             f"{want}")
    out["test_refiner --dataroot"] = dict(got, wall_s=wall,
                                          launches=launched)

    stns = sum(hasattr(m, "fc_loc") for m in cr.modules())
    want = {"affine_warp": stns * P16_IDC_BATCHES}
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with timed_loader(test_idc, None, 0, P16_IDC_BATCHES):
        acc = test_idc.main(cli_argv(dataroot=kf, cr_ckpt=files["cr_ckpt"],
                                     seed=SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before
                if kernels.LAUNCHES[k] != before[k]}
    log(f"test_idc --dataroot (K-Face test, {P16_IDC_BATCHES} batches of "
        f"{test_idc.Config.batch_size} triplets): {acc}, {wall:.1f} s with "
        f"the load; launches {launched}, the module tree gives {want} "
        f"[{smi}]")
    if launched != want or not all(0 <= acc[k] <= 1 for k in (
            "batch_accuracy", "sample_accuracy")):
        fail(f"test_idc --dataroot: {acc}, launches {launched} against "
             f"{want}")
    out["test_idc --dataroot"] = dict(acc, wall_s=wall, launches=launched)
    return out


def check_codec_path(dev, g, stats, smi, keep, mp):
    """Phase 16: the JPEG codec slice on the card, after 15, on phase 13's
    stage files in `keep` and phase 15's Multi-PIE tree `mp`: the host
    library built (g++) and its log printed; the codec against the golden
    digests (`check_golden`); a K-Face tree written by the port's encoder
    (`write_kface_tree`); the codec's and the blind branch's host times
    (`time_codec`); `infer_cr --dataroot` (K-Face val, one batch) and
    `--image` on one K-Face JPEG, card vs host CPU (`check_infer_cr`); the
    five blind training CLIs (`run_blind_clis`), `test_refiner --dataroot`
    and `test_idc --dataroot` (`run_kface_clis`) with the launch counts set
    to 0 before and read after; every map that reached a kernel in them
    held to its plain version (twice, for equal bits). Returns the numbers
    by stage, and the launches of each kernel by training stage's first
    step."""
    import tempfile

    from hifidiff_tpu_torch.data import host
    from hifidiff_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = host.library()
    out = {"build_s": time.perf_counter() - t0}
    log(f"phase 16: the host library (the JPEG codec and the data-path "
        f"core) in {out['build_s']:.2f} s; g++: {lib.build_log}")
    out["golden"] = check_golden(smi)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        kf, files, nbytes = write_kface_tree(tmp)
        log(f"phase 16: {files} K-Face JPEG files ({nbytes / 1e6:.1f} MB) "
            f"written in {time.perf_counter() - t0:.1f} s")
        out["codec_ms"] = time_codec(smi, kf)
        with timed_loader(None, None, 0, P16_EVAL_BATCHES):
            out["infer_cr --dataroot"] = check_infer_cr(
                dev, os.path.join(tmp, "infer_dataroot"), keep, smi,
                dataroot=kf)
        out["infer_cr --image"] = check_infer_cr(
            dev, os.path.join(tmp, "infer_image"), keep, smi,
            image=os.path.join(kf, "val", "val01", "S001", "L3", "E02",
                               "C12.jpg"))
        with recording(training=True) as seen:
            kernels.reset_launches()
            out.update(run_blind_clis(tmp, keep, mp, smi))
            out.update(run_kface_clis(tmp, keep, kf, smi))
            launched = dict(kernels.LAUNCHES)
    for k, n in launched.items():
        if n != sum(seen[k].values()):
            fail(f"phase 16: {k} launched {n} times, the recorded calls "
                 f"{sum(seen[k].values())}")
    log("phase 16 maps (dtype, B, C, H, W) -> calls: "
        + json.dumps({k: {"x".join(map(str, s)): n for s, n in v.items()}
                      for k, v in seen.items() if v}))
    check_recorded_shapes(dev, g, stats, seen, "phase 16")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['wall_s']:.1f} s wall [{smi}]")
    per_step = {label: n["launches_per_step"] for label, n in out.items()
                if isinstance(n, dict) and "launches_per_step" in n}
    return out, per_step

# -- phase 18: the host image library ----------------------------------------

# random (source, output) shape pairs of sides 1-300 a resize of the sweep
IMG_SWEEP_PAIRS = 16
# the datasets' items timed through a Loader, at its batch
IMG_DS_ITEMS = 256
IMG_DS_BATCH = 16
# the K-Face crop tree's angles besides the frontal
KF_CROP_ANGLES = (1, 3, 10, 20)


@contextlib.contextmanager
def counting_host_image():
    """`data.host.library` made to count the image path's calls (`hi_*`)
    into the yielded Counter, with the four plain versions made to fail
    the run where anything calls them."""
    from hifidiff_tpu_torch.data import degradations, host, image_io, resize

    lib = host.library()
    calls = collections.Counter()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if not name.startswith("hi_"):
                return fn

            def call(*args):
                calls[name] += 1
                return fn(*args)

            call.__name__ = name
            return call

    def plain_called(name):
        def stub(*a, **k):
            fail(f"phase 18: {name} reached")
            raise RuntimeError(f"{name} reached")
        return stub

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(host, "library", lambda: Counting()))
        for module, name in ((resize, "resize_cv2_plain"),
                             (resize, "resize_pil_plain"),
                             (image_io, "decode_png_plain"),
                             (degradations, "filter2d_plain")):
            stack.enter_context(patched(module, name, plain_called(name)))
        yield calls


def image_sweep():
    """Every host image function against its plain version, bit for bit
    (equal bytes): `resize_cv2` cubic / linear float32 and cubic uint8, and
    `resize_pil` bicubic / nearest, over the ratios 4/3 and 6/5, 1-pixel
    edges, the datasets' shapes and IMG_SWEEP_PAIRS random pairs of sides
    1-300 with 2-D arrays and 1-4 channels; `filter2d` with 9 x 9, 11 x 11
    and a (7, 4) kernel of negative taps on images smaller and larger than
    the kernel; `decode_png` on files of colour types 0, 2, 4 and 6 (rows
    through the five filters, IDAT in 64-byte chunks, and through Average
    or Paeth alone). Returns (cases, labels of the mismatches)."""
    from hifidiff_tpu_torch.data import degradations as deg
    from hifidiff_tpu_torch.data import image_io, resize

    rng = np.random.default_rng(SEED + 18)
    pairs = [((160, 120), (120, 90), None), ((120, 90), (160, 120), 1),
             ((150, 125), (125, 150), 3), ((125, 150), (150, 125), 4),
             ((1, 1), (5, 7), 3), ((7, 5), (1, 1), None), ((1, 9), (4, 1), 2),
             ((300, 300), (1, 300), 1), ((160, 160), (128, 128), 3),
             ((256, 256), (128, 128), 3), ((128, 128), (32, 32), 3),
             ((32, 32), (128, 128), 3)]
    for _ in range(IMG_SWEEP_PAIRS):
        src, dst = (tuple(int(v) for v in rng.integers(1, 301, 2))
                    for _ in range(2))
        pairs.append((src, dst, [None, 1, 2, 3, 4][int(rng.integers(5))]))
    bad, n = [], 0

    def same(label, got, want):
        nonlocal n
        n += 1
        if got.dtype != want.dtype or got.shape != want.shape \
                or got.tobytes() != want.tobytes():
            bad.append(label)

    for src, dst, ch in pairs:
        shape = src if ch is None else (*src, ch)
        f32 = rng.uniform(0, 1, shape).astype(np.float32)
        u8 = rng.integers(0, 256, shape, dtype=np.uint8)
        size = (dst[1], dst[0])
        for label, img, fn, plain, mode in (
                ("cv2 cubic f32", f32, resize.resize_cv2,
                 resize.resize_cv2_plain, "cubic"),
                ("cv2 linear f32", f32, resize.resize_cv2,
                 resize.resize_cv2_plain, "linear"),
                ("cv2 cubic u8", u8, resize.resize_cv2,
                 resize.resize_cv2_plain, "cubic"),
                ("pil bicubic", u8, resize.resize_pil,
                 resize.resize_pil_plain, "bicubic"),
                ("pil nearest", u8, resize.resize_pil,
                 resize.resize_pil_plain, "nearest")):
            same(f"{label} {shape} -> {dst}", fn(img, size, mode),
                 plain(img, size, mode))
    kernels = {"9x9": deg.random_mixed_kernel(rng, 9),
               "11x11": deg.random_mixed_kernel(rng, 11),
               "7x4": rng.normal(size=(7, 4)).astype(np.float32)}
    for shape in ((1, 1), (2, 3, 3), (4, 9, 1), (5, 5), (10, 10, 4),
                  (40, 33, 3), (MP_SIDE, MP_SIDE, 3)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        for name, k in kernels.items():
            same(f"filter2d {name} on {shape}", deg.filter2d(img, k),
                 deg.filter2d_plain(img, k))
    for ch in (1, 2, 3, 4):
        img = rng.integers(0, 256, (23, 37, ch), dtype=np.uint8)
        img[:11] = np.arange(37, dtype=np.uint8)[None, :, None] * 7
        for filters in ((0, 1, 2, 3, 4), (3,), (4,)):
            data = png_filtered(img if ch > 1 else img[..., 0], filters,
                                idat_size=64)
            same(f"decode_png {ch} channels, filters {filters}",
                 image_io.decode_png(data), image_io.decode_png_plain(data))
    return n, bad


def time_image_ops(smi, decode_ms):
    """ms a call of each host image operation at the datasets' shapes,
    through the host library and plain: the resizes (MP_SIDE and
    CELEBA_SIDE to 128, 128 -> 32 -> 128, the blind branch's linear ones),
    the 11 x 11 and 9 x 9 blurs of a MP_SIDE^2 face, and `blind_degrade`'s
    cv2 path an item (its blur and resizes plain in the plain row), beside
    phase 15's decode times (`decode_ms`). Returns {label: {"ms",
    "plain_ms"}}."""
    from hifidiff_tpu_torch.data import degradations as deg
    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data import resize

    rng = np.random.default_rng(SEED)
    face = {side: proc.render_face(proc._identity_params(SEED, 0), 0.3, side)
            for side in (MP_SIDE, CELEBA_SIDE, 128, 32, 20)}
    u8 = {side: (f * 255).astype(np.uint8) for side, f in face.items()}
    k11, k9 = (deg.random_mixed_kernel(rng, k) for k in (11, 9))
    cv2_ops = [(f"resize_cv2 cubic f32 {a}->{b}", face[a], (b, b), "cubic")
               for a, b in ((MP_SIDE, 128), (CELEBA_SIDE, 128), (128, 32),
                            (32, 128))]
    cv2_ops += [(f"resize_cv2 linear f32 {a}->{b}", face[a], (b, b),
                 "linear") for a, b in ((MP_SIDE, 20), (20, 128))]
    cv2_ops += [(f"resize_cv2 cubic u8 {MP_SIDE}->128", u8[MP_SIDE],
                 (128, 128), "cubic")]
    pil_ops = [(f"resize_pil bicubic {a}->{b}", u8[a], (b, b), "bicubic")
               for a, b in ((MP_SIDE, 128), (CELEBA_SIDE, 128), (128, 32),
                            (32, 128))]
    pil_ops += [(f"resize_pil nearest {MP_SIDE}->128", u8[MP_SIDE],
                 (128, 128), "nearest")]
    ops = {label: (lambda a=a, sz=sz, m=m: resize.resize_cv2(a, sz, m),
                   lambda a=a, sz=sz, m=m: resize.resize_cv2_plain(a, sz, m))
           for label, a, sz, m in cv2_ops}
    ops.update({label: (lambda a=a, sz=sz, m=m: resize.resize_pil(a, sz, m),
                        lambda a=a, sz=sz, m=m: resize.resize_pil_plain(
                            a, sz, m))
                for label, a, sz, m in pil_ops})
    for name, k in (("11x11", k11), ("9x9", k9)):
        ops[f"filter2d {name} on {MP_SIDE}x{MP_SIDE}x3"] = (
            lambda k=k: deg.filter2d(face[MP_SIDE], k),
            lambda k=k: deg.filter2d_plain(face[MP_SIDE], k))

    def blind(plain):
        g = np.random.default_rng(SEED)
        if not plain:
            return lambda: deg.blind_degrade(g, face[MP_SIDE], 128)

        def run():
            with patched(deg, "filter2d", deg.filter2d_plain), \
                    patched(deg, "resize_cv2", resize.resize_cv2_plain):
                deg.blind_degrade(g, face[MP_SIDE], 128)
        return run

    ops[f"blind_degrade, cv2 path, {MP_SIDE}x{MP_SIDE} -> 128"] = (
        blind(False), blind(True))
    out = {f"imread_rgb {k}": v for k, v in decode_ms.items()}
    for label, (lib_fn, plain_fn) in ops.items():
        out[label] = dict(ms=median_ms(lib_fn, 21),
                          plain_ms=median_ms(plain_fn, 5))
    for label, v in out.items():
        log(f"phase 18 on the host: {label}: {v['ms']:.3f} ms through the "
            f"host library, {v['plain_ms']:.3f} ms plain "
            f"({v['plain_ms'] / v['ms']:.1f}x) [{smi}]")
    return out


def write_kface_crop_tree(root):
    """A pre-cropped K-Face tree under `root/kface_crop` (the train split,
    2 ids, lights L1 and L2, expressions E01-E03, the frontal C7 and the
    angles of KF_CROP_ANGLES at KF_SIDE^2, each angle's 8 component patches
    at 128^2), JPEGs written by the port's encoder at KF_QUALITY. Returns
    the root."""
    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data.jpeg import encode_jpeg

    kf = os.path.join(root, "kface_crop")
    for i in range(2):
        idp = proc._identity_params(SEED + 18, i)
        for light, gain in (("L1", 1.0), ("L2", 0.8)):
            for e, expr in enumerate(KF_EXPRESSIONS):
                d = os.path.join(kf, "train", f"k{i}", "S001", light, expr)
                os.makedirs(d, exist_ok=True)
                for angle in (KF_FRONTAL, *KF_CROP_ANGLES):
                    pose = 0.0 if angle == KF_FRONTAL else -0.8 + 0.08 * angle
                    img = proc.render_face(idp, pose, KF_SIDE) * gain
                    img = (np.clip(np.roll(img, e, axis=1), 0, 1) * 255
                           + 0.5).astype(np.uint8)
                    with open(os.path.join(d, f"C{angle}.jpg"), "wb") as f:
                        f.write(encode_jpeg(img, KF_QUALITY))
                    if angle == KF_FRONTAL:
                        continue
                    for k in range(8):
                        patch = np.ascontiguousarray(img[k * 4:k * 4 + 128,
                                                         16:144])
                        with open(os.path.join(d, f"C{angle}_{k}.jpg"),
                                  "wb") as f:
                            f.write(encode_jpeg(patch, KF_QUALITY))
    return kf


class FirstItems:
    """`n` items of a dataset: its first ones, from the start again where
    it has fewer."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def time_datasets(smi, mp, celeba, kf):
    """Items a second of the image datasets through the port's `Loader`
    (batch IMG_DS_BATCH, IMG_DS_ITEMS items, one pass after one
    warm item), with 4 threads (the CLIs' loaders) and with 1; before it,
    one item of each with the host library's calls counted and the plain
    versions made to fail: each must reach the calls it makes. Returns
    {label: numbers}."""
    from hifidiff_tpu_torch.data import kface, multipie, pretraining
    from hifidiff_tpu_torch.data.core import Loader

    png, blur, pil = "hi_png_rgb", "hi_filter2d", "hi_resize_pil"
    cv2_f32 = "hi_resize_cv2_f32"
    cases = {
        "MultiPIEDataset (blind branch, patches)": (
            lambda: multipie.MultiPIEDataset(mp, use_patch=True, seed=SEED),
            {png, blur, cv2_f32, pil}),
        "MultiPIEDataset (not blind, patches)": (
            lambda: multipie.MultiPIEDataset(mp, use_blind=False,
                                             use_patch=True, seed=SEED),
            {png, cv2_f32, pil}),
        "MultiPIEHQDataset": (lambda: pretraining.MultiPIEHQDataset(mp),
                              {png, cv2_f32}),
        "CelebAHQDataset": (lambda: pretraining.CelebAHQDataset(celeba),
                            {png, pil}),
        "KFaceCropDataset (patches)": (lambda: kface.KFaceCropDataset(kf),
                                       {pil}),
    }
    out = {}
    for label, (make, want) in cases.items():
        with counting_host_image() as calls:
            make()[0]
        if set(calls) != want:
            fail(f"phase 18: {label} made the host library calls "
                 f"{dict(calls)}, not {sorted(want)}")
        row = {"host_calls_an_item": dict(calls)}
        for threads in (4, 1):
            ds = FirstItems(make(), IMG_DS_ITEMS)
            ds[0]
            t0 = time.perf_counter()
            n = sum(len(next(iter(b.values())))
                    for b in Loader(ds, IMG_DS_BATCH, shuffle=False,
                                    num_threads=threads))
            row[f"items_s_{threads}_threads"] = n / (time.perf_counter() - t0)
            row["items"] = n
        log(f"phase 18: {label}: {row['items_s_4_threads']:.1f} items/s "
            f"through a 4-thread Loader, {row['items_s_1_threads']:.1f} "
            f"with 1 ({row['items']} items, batch {IMG_DS_BATCH}); host "
            f"library calls an item {row['host_calls_an_item']} [{smi}]")
        out[label] = row
    return out


def check_host_image(smi, png_stats, mp, celeba):
    """Phase 18: the host image library (csrc/host/image.cc) on the card's
    host: its build log (per-source flags, seconds), every function against
    its plain version bit for bit (`image_sweep`), the ms of each operation
    against the plain version's (`time_image_ops`, beside phase 15's
    decodes) and the datasets' items a second through the Loader, each
    dataset's item reaching the library (`time_datasets`, on phase 15's
    Multi-PIE and CelebA-HQ trees and a K-Face crop tree written here).
    Returns its numbers."""
    import tempfile

    from hifidiff_tpu_torch.data import host

    t_phase = time.perf_counter()
    log("phase 18: the host library's build (each source its own g++, at "
        "once; seconds since the build began):\n" + host.library().build_log)
    out = {}
    t0 = time.perf_counter()
    n, bad = image_sweep()
    out["sweep"] = dict(cases=n, mismatches=bad, s=time.perf_counter() - t0)
    log(f"phase 18: {n} calls of the host image library against the plain "
        f"versions: {len(bad)} not bit for bit"
        + (f" ({bad[:8]})" if bad else "")
        + f", {out['sweep']['s']:.1f} s")
    if bad:
        fail(f"phase 18: {len(bad)} of {n} host image calls differ from "
             f"the plain versions, e.g. {bad[:4]}")
    out["ms"] = time_image_ops(smi, png_stats["decode_ms"])
    with tempfile.TemporaryDirectory() as tmp:
        out["datasets"] = time_datasets(smi, mp, celeba,
                                        write_kface_crop_tree(tmp))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['wall_s']:.1f} s wall [{smi}]")
    return out


# -- phase 19: the image formats the decoders gained --------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")
# the progressive fixtures of tests/fixtures/jpeg, and the two phase 19
# times on the host
PROGRESSIVE_FACE = "pil_prog_face_q95_160x160.jpg"
PROGRESSIVE_FRAME = "pil_prog_frame_q95_1920x1080.jpg"


def same_coefficients(data, plain=None):
    """Whether the host library's coefficients of a JPEG file
    (`jpeg.coefficients`) equal the Python decoder's
    (`jpeg.coefficients_plain`, or `plain` where it was computed),
    bit for bit."""
    from hifidiff_tpu_torch.data import jpeg

    lib = jpeg.coefficients(data)
    plain = jpeg.coefficients_plain(data) if plain is None else plain
    return len(lib) == len(plain) and all(
        (a["h"], a["v"]) == (b["h"], b["v"])
        and a["quant"].tobytes() == b["quant"].tobytes()
        and a["coef"].shape == b["coef"].shape
        and a["coef"].tobytes() == b["coef"].tobytes()
        for a, b in zip(lib, plain))


def check_format_golden(smi):
    """tests/fixtures/png and tests/fixtures/bmp against their digests.json
    (PIL's and cv2's decodes, written where both exist): every file decoded
    by the host library and by the plain version to the SHA-256 of each
    library's decode, with `reader` set to that library for PNG; each
    refused file refused by both with the message the digests name; the
    coefficients of every progressive JPEG fixture (phase 16 holds their
    RGB to the digests) equal to the plain decoder's, but the 1920 x 1080
    frame's, which `time_formats` checks as it times it; and of every
    four-component JPEG fixture, whose RGB by each reader equals the plain
    colour steps (YCCK -> CMYK, CMYK -> RGB) on the library's components.
    Returns the counts and the mismatches."""
    import re

    from hifidiff_tpu_torch.data import image_io, jpeg

    bad, n = [], collections.Counter()
    for sub in ("png", "bmp"):
        root = os.path.join(FIXTURES, sub)
        with open(os.path.join(root, "digests.json")) as f:
            golden = json.load(f)

        def read(name):
            with open(os.path.join(root, name), "rb") as f:
                return f.read()

        for name, by_how in golden["decode"].items():
            data = read(name)
            for how, want in by_how.items():
                for fn in ((image_io.decode_png, image_io.decode_png_plain)
                           if sub == "png" else
                           (image_io.decode_bmp, image_io.decode_bmp_plain)):
                    rgb = (fn(data, reader=how) if sub == "png"
                           else fn(data))
                    n[f"{sub} decodes"] += 1
                    if [list(rgb.shape), sha256_hex(rgb.tobytes())] != [
                            want["shape"], want["sha256"]]:
                        bad.append(f"{fn.__name__} {name} ({how})")
        for name, what in golden["refuse"].items():
            for fn in ((image_io.decode_png, image_io.decode_png_plain)
                       if sub == "png" else
                       (image_io.decode_bmp, image_io.decode_bmp_plain)):
                n[f"{sub} refusals"] += 1
                try:
                    fn(read(name), **({"reader": "cv2"}
                                      if sub == "png" else {}))
                    bad.append(f"{fn.__name__} {name} decoded")
                except ValueError as e:
                    if not re.search(what, str(e)):
                        bad.append(f"{fn.__name__} {name}: {e}")
    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        golden = json.load(f)
    progressive = [k for k in golden["decode"]
                   if "prog" in k and k != PROGRESSIVE_FRAME]
    for name in progressive:
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        n["progressive coefficients"] += 1
        if not same_coefficients(data):
            bad.append(f"coefficients {name}")
    for name in golden["decode_by_reader"]:
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        n["four-component coefficients"] += 1
        if not same_coefficients(data):
            bad.append(f"coefficients {name}")
        px, space = jpeg.components(data)
        if space == "ycck":
            px = jpeg.ycck_to_cmyk_plain(px)
        for how in jpeg.READERS:
            n["four-component plain colour steps"] += 1
            if jpeg.cmyk_to_rgb_plain(px, how).tobytes() != \
                    jpeg.decode_jpeg(data, how).tobytes():
                bad.append(f"colour steps {name} ({how})")
    log(f"phase 19: golden digests of tests/fixtures/png and bmp: "
        f"{dict(n)}; mismatches: {bad or 'none'} [{smi}]")
    if bad:
        fail(f"phase 19: the decoders disagree with the golden digests or "
             f"their plain versions: {bad}")
    return dict(n, mismatches=len(bad))


def check_webp_golden(smi):
    """tests/fixtures/webp and tests/fixtures/orientation against their
    digests.json (PIL's and cv2's decodes, written where both exist): every
    WebP file decoded by the host library to the SHA-256 of both
    libraries' decode, the lossless ones by the plain version too and the
    lossy ones with the plain parse's coefficients (`vp8_coefficients`
    against `vp8_coefficients_plain`), each ALPH chunk's alpha by the
    library and the plain version to PIL's; each refused file refused with the
    message the digests name; every orientation file read with
    `reader="cv2"` to cv2.imread's digest (flipped and transposed by its
    EXIF orientation) and with "pil" to PIL's. The 1024 x 1024 files' plain
    versions run in `time_webp`, which holds them to the library. Returns
    the counts and the mismatches."""
    import re

    from hifidiff_tpu_torch.data import image_io, webp

    bad, n = [], collections.Counter()
    for sub in ("webp", "orientation"):
        root = os.path.join(FIXTURES, sub)
        with open(os.path.join(root, "digests.json")) as f:
            golden = json.load(f)
        for name, by_how in golden["decode"].items():
            with open(os.path.join(root, name), "rb") as f:
                data = f.read()
            for how, want in by_how.items():
                rgb = (webp.decode_webp(data) if sub == "webp"
                       else image_io.decode_image(data, reader=how))
                n[f"{sub} decodes"] += 1
                if [list(rgb.shape), sha256_hex(rgb.tobytes())] != [
                        want["shape"], want["sha256"]]:
                    bad.append(f"{name} ({how})")
            if sub == "orientation":
                continue
            f = webp.parse(data)
            if f.alpha is not None:
                want = golden["alpha"][name]
                payload = data[f.alpha[0]:sum(f.alpha)]
                a = webp.decode_alpha(payload, f.width, f.height)
                n["webp alpha"] += 1
                if [list(a.shape), sha256_hex(a.tobytes())] != [
                        want["shape"], want["sha256"]] or a.tobytes() != \
                        webp.decode_alpha_plain(payload, f.width,
                                                f.height).tobytes():
                    bad.append(f"alpha {name}")
            if name in WEBP_TIMED:
                continue
            if f.lossless:
                n["webp lossless plain"] += 1
                if webp.decode_webp_plain(data).tobytes() != rgb.tobytes():
                    bad.append(f"plain {name}")
            else:
                n["webp lossy coefficients"] += 1
                lib = webp.vp8_coefficients(data)
                plain = webp.vp8_coefficients_plain(data)
                if any(a.tobytes() != b.tobytes() for a, b in zip(lib,
                                                                  plain)):
                    bad.append(f"coefficients {name}")
        for name, what in golden.get("refuse", {}).items():
            with open(os.path.join(root, name), "rb") as f:
                data = f.read()
            n[f"{sub} refusals"] += 1
            try:
                webp.decode_webp(data)
                bad.append(f"{name} decoded")
            except webp.WebPError as e:
                if not re.search(what, str(e)):
                    bad.append(f"{name}: {e}")
    log(f"phase 19: golden digests of tests/fixtures/webp and orientation: "
        f"{dict(n)}; mismatches: {bad or 'none'} [{smi}]")
    if bad:
        fail(f"phase 19: the WebP reader or the EXIF orientation disagrees "
             f"with the golden digests or the plain versions: {bad}")
    return dict(n, mismatches=len(bad))


# the WebP fixtures `time_webp` times (and holds to their plain versions):
# the 160 x 160 face and the 1024 x 1024 frame (CelebA-HQ's size), and the
# 160 x 160 animations
WEBP_TIMED = ("lossless_face_160x160.webp", "lossless_frame_1024x1024.webp",
              "lossy_face_q90_160x160.webp", "lossy_frame_q80_1024x1024.webp",
              "anim_lossless_face_160x160.webp", CELEBA_WEBP[2])


def time_webp(smi):
    """Host ms a WebP file through the host library and plain, on the
    fixtures WEBP_TIMED, lossless (the plain version: the whole decode in
    Python) and lossy (the plain version: the parse up to the
    coefficients, and the ALPH chunk's alpha where there is one), each
    plain result held to the library's. Returns {label: {"ms", "plain_ms",
    "bytes"[, "alpha_plain_ms"]}}."""
    from hifidiff_tpu_torch.data import webp

    out = {}
    for name in WEBP_TIMED:
        with open(os.path.join(FIXTURES, "webp", name), "rb") as f:
            data = f.read()
        n_lib, n_plain = (21, 3) if "160x160" in name else (5, 1)
        if "lossless" in name:
            lib, plain = webp.decode_webp, webp.decode_webp_plain
        else:
            lib, plain = webp.vp8_coefficients, webp.vp8_coefficients_plain
        t0 = time.perf_counter()
        got = plain(data)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not all(a.tobytes() == b.tobytes() for a, b in zip(
                (lib(data),) if "lossless" in name else lib(data),
                (got,) if "lossless" in name else got)):
            fail(f"phase 19: the plain version of {name} differs from the "
                 "host library")
        label = name[:-5].replace("_", " ")
        out[label] = dict(
            ms=median_ms(lambda: webp.decode_webp(data), n_lib),
            plain_ms=plain_ms if n_plain == 1 else median_ms(
                lambda: plain(data), n_plain),
            bytes=len(data))
        f = webp.parse(data)
        if f.alpha is not None:
            payload = data[f.alpha[0]:sum(f.alpha)]
            t0 = time.perf_counter()
            alpha = webp.decode_alpha_plain(payload, f.width, f.height)
            out[label]["alpha_plain_ms"] = (time.perf_counter() - t0) * 1e3
            if alpha.tobytes() != webp.decode_alpha(payload, f.width,
                                                    f.height).tobytes():
                fail(f"phase 19: the plain alpha of {name} differs from "
                     "the host library's")
        log(f"phase 19 on the host: WebP {label} ({len(data)} bytes): "
            f"{out[label]['ms']:.3f} ms a file through the host library, "
            f"{out[label]['plain_ms']:.2f} ms plain"
            + ("" if "lossless" in name else " (the parse up to the "
               "coefficients)")
            + (f", {out[label]['alpha_plain_ms']:.2f} ms its alpha plain"
               if "alpha_plain_ms" in out[label] else "") + f" [{smi}]")
    return out


def webp_body():
    """Phase 19's WebP body for the server: the lossy 160 x 160 face of
    tests/fixtures/webp."""
    with open(os.path.join(FIXTURES, "webp", CELEBA_WEBP[0]), "rb") as f:
        return {"a lossy WebP request (phase 19)": f.read()}


def animated_and_cmyk_bodies():
    """Two more bodies for the server: the 160 x 160 lossy animation with
    alpha of tests/fixtures/webp and the 160 x 160 CMYK JPEG of
    tests/fixtures/jpeg (read by PIL's CMYK -> RGB, as the JAX handler's
    PIL reads it)."""
    with open(os.path.join(FIXTURES, "webp", CELEBA_WEBP[2]), "rb") as f:
        animated = f.read()
    with open(os.path.join(JPEG_FIXTURES, CELEBA_CMYK), "rb") as f:
        cmyk = f.read()
    return {"an animated WebP request (phase 19)": animated,
            "a CMYK JPEG request (phase 19)": cmyk}


def format_sweep():
    """The host library against its plain versions on the new paths, over
    files written here: PNG of every colour type and bit depth, Adam7 and
    not, at sizes that leave passes empty and at 64 x 48, with both 16-bit
    readings; BMP of every layout (palettes of 1, 4 and 8 bits, PIL's grey
    ramps, 16-bit 5-5-5 / 5-6-5, 24 and 32 bits, bitfields, RLE8 and RLE4,
    top-down) at three sizes; then `colour_and_alpha_sweep`. Returns
    (calls, mismatches)."""
    from hifidiff_tpu_torch.data import image_io

    rng = np.random.default_rng(SEED)
    calls, bad = 0, []
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
    for color, ds in depths.items():
        for depth in ds:
            for h, w in ((1, 1), (1, 9), (9, 1), (7, 5), (48, 64)):
                for lace in (0, 1):
                    top = min(1 << depth, 200 if color == 3 else 1 << depth)
                    samples = rng.integers(0, top, (h, w, channels[color]))
                    pal = (rng.integers(0, 256, (top, 3)) if color == 3
                           else None)
                    data = png_file(samples, depth, color, lace, palette=pal)
                    for how in ("cv2", "pil"):
                        calls += 1
                        got = image_io.decode_png(data, reader=how)
                        plain = image_io.decode_png_plain(data,
                                                          reader=how)
                        if got.tobytes() != plain.tobytes():
                            bad.append(f"png c{color} d{depth} {h}x{w} "
                                       f"lace {lace} {how}")
    # (bits, a grey-ramp palette, bmp_file's options)
    layouts = [(1, False, {}), (4, False, {}), (8, False, {}),
               (4, False, dict(rle=True)), (8, False, dict(rle=True)),
               (4, True, {}), (8, True, {}), (16, False, {}),
               (16, False, dict(fields="565")), (24, False, {}),
               (24, False, dict(topdown=True)), (32, False, {}),
               (32, False, dict(fields="BGRA")),
               (32, False, dict(fields="XBGR"))]

    def decoded(fn, data):
        try:
            return fn(data).tobytes()
        except image_io.BMPError as e:   # refused by both, one message
            return str(e)

    for bits, grey, kw in layouts:
        for h, w in ((1, 1), (3, 4), (37, 29)):
            if bits <= 8:
                colors = 1 << bits
                idx = rng.integers(0, colors, (h, w))
                idx[:, ::2] = idx[:, :1]           # runs for RLE
                pal = (np.repeat(np.arange(colors)[:, None], 3, 1) if grey
                       else rng.integers(0, 256, (colors, 3)))
                data = bmp_file(idx, bits, palette=pal, **kw)
            else:
                data = bmp_file(rng.integers(0, 256, (h, w, 3), np.uint8),
                                bits, **kw)
            calls += 1
            if decoded(image_io.decode_bmp, data) != decoded(
                    image_io.decode_bmp_plain, data):
                bad.append(f"bmp {bits} grey {grey} {kw} {h}x{w}")
    return colour_and_alpha_sweep(rng, calls, bad)


def colour_and_alpha_sweep(rng, calls, bad):
    """`format_sweep`'s part for the four-component JPEG colour steps and
    the WebP alpha, `calls` and `bad` carried on: YCCK -> CMYK and both
    readers' CMYK -> RGB on all 65,536 (C, K) pairs (M and Y, and Y, Cb,
    Cr, other values in step), library against plain; raw ALPH payloads
    of seeded alpha at four sizes through each of the four filters, the
    library's and the plain version's alpha against the alpha written."""
    from hifidiff_tpu_torch.data import jpeg, webp

    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([c, (c + 85) % 256, (c + 170) % 256, k], -1).astype(
        np.uint8)
    steps = [("ycck", jpeg.ycck_to_cmyk(px), jpeg.ycck_to_cmyk_plain(px))]
    steps += [(how, jpeg.cmyk_to_rgb(px, how), jpeg.cmyk_to_rgb_plain(
        px, how)) for how in jpeg.READERS]
    for label, lib, plain in steps:
        calls += 1
        if lib.tobytes() != plain.tobytes():
            bad.append(f"jpeg colour step {label}")
    for h, w in ((1, 1), (1, 9), (7, 5), (23, 29)):
        alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
        a = alpha.astype(np.int64)
        for method in range(4):
            pred = np.zeros_like(a)     # the filter's prediction
            if method:
                pred[0, 1:] = a[0, :-1]
                pred[1:, 0] = a[:-1, 0]
                pred[1:, 1:] = (a[1:, :-1], a[:-1, 1:], np.clip(
                    a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255))[
                        method - 1]
            payload = bytes([method << 2]) + ((a - pred) & 0xFF).astype(
                np.uint8).tobytes()
            calls += 1
            if webp.decode_alpha(payload, w, h).tobytes() != alpha.tobytes() \
                    or webp.decode_alpha_plain(payload, w,
                                               h).tobytes() != alpha.tobytes():
                bad.append(f"alpha filter {method} {h}x{w}")
    return calls, bad


def time_formats(smi):
    """Host ms a file of the new formats, through the host library and
    plain: the progressive JPEG fixtures (160 x 160 and 1920 x 1080; the
    library's whole decode, its entropy decoding alone
    (`jpeg.coefficients`) and the plain entropy decoding), the 160 x 160
    CMYK fixture by each reader (plain: the entropy decoding and both
    readers' colour steps on the library's components), and a 160 x 160
    procedural face as an Adam7 8-bit RGB PNG, a 16-bit RGB PNG (Adam7)
    and a 24-bit BMP. Returns {label: {"ms", "plain_ms"[, "entropy_ms"]}}."""
    from hifidiff_tpu_torch.data import image_io, jpeg
    from hifidiff_tpu_torch.data import procedural as proc

    out = {}
    for name, n_lib, n_plain in ((PROGRESSIVE_FACE, 21, 3),
                                 (PROGRESSIVE_FRAME, 5, 1)):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        size = name.rsplit("_", 1)[1][:-4]
        t0 = time.perf_counter()
        plain = jpeg.coefficients_plain(data)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not same_coefficients(data, plain):
            fail(f"phase 19: the coefficients of {name} differ from the "
                 "plain decoder's")
        out[f"progressive JPEG {size}"] = dict(
            ms=median_ms(lambda: jpeg.decode_jpeg(data), n_lib),
            entropy_ms=median_ms(lambda: jpeg.coefficients(data), n_lib),
            plain_ms=plain_ms if n_plain == 1 else median_ms(
                lambda: jpeg.coefficients_plain(data), n_plain))
    face = (proc.render_face(proc._identity_params(SEED, 2), 0.1, MP_SIDE)
            * 255).astype(np.uint8)
    files = {f"Adam7 8-bit RGB PNG {MP_SIDE}x{MP_SIDE}":
                 (png_file(face, 8, 2, interlace=1), image_io.decode_png,
                  image_io.decode_png_plain),
             f"Adam7 16-bit RGB PNG {MP_SIDE}x{MP_SIDE}":
                 (png_file(face.astype(np.int64) * 257, 16, 2, interlace=1),
                  image_io.decode_png, image_io.decode_png_plain),
             f"24-bit BMP {MP_SIDE}x{MP_SIDE}":
                 (bmp_file(face, 24), image_io.decode_bmp,
                  image_io.decode_bmp_plain)}
    with open(os.path.join(JPEG_FIXTURES, CELEBA_CMYK), "rb") as f:
        cmyk = f.read()
    t0 = time.perf_counter()
    plain = jpeg.coefficients_plain(cmyk)
    colour = {how: jpeg.cmyk_to_rgb_plain(jpeg.components(cmyk)[0], how)
              for how in jpeg.READERS}
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not same_coefficients(cmyk, plain) or any(
            colour[how].tobytes() != jpeg.decode_jpeg(cmyk, how).tobytes()
            for how in jpeg.READERS):
        fail(f"phase 19: {CELEBA_CMYK} differs from its plain version")
    for how in jpeg.READERS:
        out[f"CMYK JPEG 160x160, reader {how}"] = dict(
            ms=median_ms(lambda: jpeg.decode_jpeg(cmyk, how), 21),
            plain_ms=plain_ms)
    for label, (data, lib, plain) in files.items():
        kw = {"reader": "pil"} if lib is image_io.decode_png else {}
        if lib(data, **kw).tobytes() != plain(data, **kw).tobytes() \
                or not np.array_equal(lib(data, **kw), face):
            fail(f"phase 19: {label} does not read back bit for bit")
        out[label] = dict(ms=median_ms(lambda: lib(data, **kw), 21),
                          plain_ms=median_ms(lambda: plain(data, **kw), 5))
    for label, v in out.items():
        log(f"phase 19 on the host: {label}: {v['ms']:.3f} ms a file "
            "through the host library"
            + (f" ({v['entropy_ms']:.3f} ms its entropy decoding alone)"
               if "entropy_ms" in v else "")
            + f", {v['plain_ms']:.2f} ms plain"
            + (" (the entropy decoding)" if "entropy_ms" in v else "")
            + f" [{smi}]")
    return out


def check_image_formats(dev, smi, keep, tmp):
    """Phase 19: the image formats the decoders gained (progressive JPEG,
    Adam7 and 16-bit PNG, BMP, WebP, animated WebP, CMYK, YCCK and
    RGB-coded JPEG) and the EXIF orientation of the cv2
    sites, after 18, with phase 13's stage files in `keep` and a directory
    `tmp`: the golden digests of tests/fixtures (`check_format_golden`,
    `check_webp_golden`), the host library against its plain versions
    (`format_sweep`), host times (`time_formats`, `time_webp`), and
    `infer_cr --image` on the card and on the host CPU on one progressive
    JPEG, one BMP, one lossy WebP, one animated WebP and one CMYK JPEG
    (`check_infer_cr`: phase 4's limits, 9 warp launches a call). Phase
    12's server took its five bodies (`format_bodies`, `webp_body`,
    `animated_and_cmyk_bodies`) and phase 15's `pretrain_denoiser
    --celeba-root` its mixed CelebA-HQ files (`celeba_file`, WebP,
    animated WebP and CMYK JPEG among them). Returns the numbers."""
    from hifidiff_tpu_torch.data import procedural as proc

    t_phase = time.perf_counter()
    out = {"golden": check_format_golden(smi),
           "webp golden": check_webp_golden(smi)}
    t0 = time.perf_counter()
    n, bad = format_sweep()
    out["sweep"] = dict(cases=n, mismatches=bad, s=time.perf_counter() - t0)
    log(f"phase 19: {n} calls of the host library on the new formats "
        f"against the plain versions: {len(bad)} not bit for bit"
        + (f" ({bad[:8]})" if bad else "")
        + f", {out['sweep']['s']:.1f} s")
    if bad:
        fail(f"phase 19: {len(bad)} of {n} decodes differ from the plain "
             f"versions, e.g. {bad[:4]}")
    out["ms"] = time_formats(smi)
    out["webp ms"] = time_webp(smi)
    face = (proc.render_face(proc._identity_params(SEED, 7), 0.25, MP_SIDE)
            * 255).astype(np.uint8)
    bmp = os.path.join(tmp, "face.bmp")
    with open(bmp, "wb") as f:
        f.write(bmp_file(face, 24))
    for label, path in (("progressive JPEG", os.path.join(
            JPEG_FIXTURES, PROGRESSIVE_FACE)), ("BMP", bmp),
            ("lossy WebP", os.path.join(FIXTURES, "webp", CELEBA_WEBP[0])),
            ("animated WebP", os.path.join(FIXTURES, "webp",
                                           CELEBA_WEBP[2])),
            ("CMYK JPEG", os.path.join(JPEG_FIXTURES, CELEBA_CMYK))):
        out[f"infer_cr {label}"] = check_infer_cr(dev, tmp, keep, smi,
                                                  image=path)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['wall_s']:.1f} s wall [{smi}]")
    return out


# -- phase 17: data parallelism over torch.distributed ------------------------
# Phase 17's train steps run on deterministic algorithms with cuDNN's
# convolutions off (torch's own, which compute a row at a time): cuDNN's
# convolutions give other bits at 16 rows a rank than at 32 in one process
# (4 of a refiner step's 1306 calls, 3e-6), which moves the HCA blocks'
# gradients by 1e-2. (b) holds that path too, and witnesses the cause.
# (a) A process group of world size 1 on NCCL in this process against the
#     same steps without a group: losses, parameters, BatchNorm statistics
#     and EMA bit for bit (the gradient all-reduce and the global-mean loss
#     run; BatchNorm takes its own batch's statistics at world size 1).
# (b) Two processes on the one card over gloo (NCCL refuses two ranks on one
#     device; gloo takes `all_reduce`, `broadcast` and `barrier` on CUDA
#     tensors), each on its half of the batch, against one process without
#     a group on the concatenated batch (rank 0's rows first), recomputed
#     in rank 0 and identified with (a)'s by its digest; f32, TF32 off; to
#     the limits of tests/test_torch_parallel.py. The refiner: the losses
#     1e-5 relative; the first step's gradients, the worst tensor's largest
#     difference 5e-4 of its largest value (1e-4 of the model's largest
#     gradient as the floor; a tensor under it on both sides is rounding
#     noise and left out of the parameter readings); after the steps at
#     most 1e-3 of the trained entries (parameters and EMA) more than 5e-2
#     of a learning rate per update apart and none a whole rate; BatchNorm
#     statistics 1e-3 of the tensor's largest value. The IDC (ROADMAP §C2:
#     its float32 gradient is ill-conditioned, Adam's first updates
#     sign-like, so an entry whose gradient is rounding noise moves by +-lr):
#     both runs set to the one-process run's state after each step; the
#     losses 1e-4, the first step's gradient at a cosine of 0.99 or more, at
#     most a tenth of the trained entries more than 5e-2 of a rate apart (an
#     update of the wrong sign moves nearly all of them by two), the
#     statistics 1e-3. Its witness in float64 ("idc64": the IDC and its
#     optimizer in float64, the frozen CR's faces made a row at a time so
#     that they do not depend on the batch's size): losses 1e-10, gradients
#     1e-8 of a tensor's largest, cosine 1 - 1e-10, 1e-4 of the entries
#     past 5e-2 of a rate, statistics 1e-10; and, for the cause of the
#     float32 gap, one process with BatchNorm's statistics summed by the
#     data-parallel formula without a group against torch's own (logged).
#     For scale (not for the float64 witness), the same readings of one
#     process on the batch shuffled (a seeded permutation of its rows and
#     draws) against one process. The
#     two ranks' states are equal bit for bit after every step (digests),
#     and every map that reached `ln_film`, `ln_film_bwd` or the warp on
#     either rank is held to its plain version (`check_recorded_shapes`).
#     The refiner on cuDNN's deterministic convolutions (the users' path):
#     two ranks against one process to DP_CUDNN_LIMITS. The witnesses, each
#     against one process and the two ranks against each (logged): one
#     process whose convolutions on the 32 rows are each made as two calls
#     on 16 (what each rank runs), one with BatchNorm's statistics by the
#     data-parallel formula, and one with both; and every such call's two
#     halves against the 32-row call, with cuDNN and without. Held: the
#     halves alone read at least half the two ranks' gap to one process
#     (loss, gradients, share of entries), BatchNorm's formula a tenth or
#     less.
#     Then `train_refiner` (batch 16 a rank, 64 synthetic faces: two steps,
#     and validation on 16) and `pretrain_idc` (12 a rank, 24: one step, and
#     validation on 6; at a learning rate of 0, so that its validation reads
#     the same parameters: (b) holds its update) run by their `main` on the
#     two ranks, against one process at the global batch whose Loaders
#     yield the ranks' batches concatenated (`ConcatShards`): logged train
#     losses, val metrics and the checkpoint rank 0 wrote, to DP_CLI_LIMITS
#     (the IDC's losses at ten times (b)'s limit: a fault of the wiring moves
#     them by the data's spread, 1e-2 and more).
# (c) `test_refiner` on the two processes (batch 1 each) against one process
#     at batch 2 (1e-5 relative), and the server with `--mesh-devices 0`
#     serving on the one card.
DP_BATCH = {"refiner": 32, "idc": 24, "idc64": 24}
DP_STEPS = 2
DP_CAPTURE_ROWS = 8
DP_EMA = 0.9
# upper limits, but the gradient's cosine: a lower one
DP_LIMITS = {"refiner": {"loss_rel": 1e-5, "grad_rel": 5e-4,
                         "param_share": 1e-3, "param_far_lr": 1.0,
                         "stats_rel": 1e-3},
             "idc": {"loss_rel": 1e-4, "grad_cosine": 0.99,
                     "param_share": 0.1, "stats_rel": 1e-3},
             "idc64": {"loss_rel": 1e-10, "grad_rel": 1e-8,
                       "grad_cosine": 1 - 1e-10, "param_share": 1e-4,
                       "stats_rel": 1e-10}}
# the refiner on cuDNN's convolutions, two ranks against one process: a
# bound on the users' path (readings 1.4e-5, 1.3e-2, 3.5e-2 and 3.0e-4
# before it was set, PR 13)
DP_CUDNN_LIMITS = {"loss_rel": 1e-4, "grad_rel": 5e-2, "param_share": 0.1,
                   "stats_rel": 3e-3}
DP_GRAD_FLOOR, DP_PARAM_LR = 1e-4, 5e-2
DP_EVAL_REL = 1e-5
DP_TIMEOUT = 600
DP_EVAL_ARGV = ["--procedural", "8", "--num-inference-steps", "10",
                "--grid-every", "0", "--seed", str(SEED)]
# the training CLIs on two ranks: (the JSONL's project, flags, the global
# batch, the learning rate)
DP_CLI = {"train_refiner": ("hifi_refiner",
                            ["--synthetic", "64", "--num-epochs", "1",
                             "--warmup-steps", "0", "--ema-decay", "0.9",
                             "--num-inference-steps", "2"], 32, 1e-4),
          "pretrain_idc": ("hifi_idc", ["--synthetic", "24", "--num-epochs",
                                        "1", "--lr", "0"], 24, 0.0)}
DP_CLI_LIMITS = {"train_refiner": {"loss_rel": 1e-5, "val_rel": 1e-4,
                                   "param_share": 1e-3, "stats_rel": 1e-3},
                 "pretrain_idc": {"loss_rel": 1e-3, "val_rel": 1e-3,
                                  "param_abs": 0.0, "stats_rel": 1e-3}}


@contextlib.contextmanager
def deterministic(cudnn=False):
    """Torch's deterministic mode (warning, not raising, where an operator
    has none) with cuDNN's convolutions off (`cudnn`: cuDNN's deterministic
    ones) while the block runs; yields the warnings' texts."""
    import warnings

    was = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            texts = []
            yield texts
            texts.extend(sorted({str(w.message).split("\n")[0][:160]
                                 for w in caught
                                 if "deterministic" in str(w.message)}))
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = \
            was[:2]
        torch.use_deterministic_algorithms(was[2])


class RowwiseCast(torch.nn.Module):
    """A frozen float32 module whose output is made a row at a time (so
    that it does not depend on the batch's size) and cast to `dtype`."""

    def __init__(self, module, dtype):
        super().__init__()
        self.module, self.dtype = module, dtype

    def forward(self, x):
        return torch.cat([self.module(r[None].float())
                          for r in x]).to(self.dtype)


@contextlib.contextmanager
def bn_by_formula():
    """BatchNorm's training statistics by the data-parallel formula
    (`BatchNorm2d._forward_global`: the sum, then the squared deviations)
    over this process's batch, in place of torch's own, while the block
    runs."""
    from hifidiff_tpu_torch.nn.layers import BatchNorm2d

    real = BatchNorm2d.forward

    def forward(self, x):
        return self._forward_global(x, None) if self.training \
            else real(self, x)

    with patched(BatchNorm2d, "forward", forward):
        yield


@contextlib.contextmanager
def conv_in_halves(rows, seen):
    """Every `F.conv2d` on `rows` rows made as two calls on half the rows
    each (what each of two ranks runs) while the block runs; for each, the
    two halves' largest difference from the whole call, relative to its
    largest value, is appended to `seen` (the whole call is made for it,
    without gradient)."""
    import torch.nn.functional as F

    real = F.conv2d

    def conv2d(x, *a, **k):
        if x.shape[0] != rows:
            return real(x, *a, **k)
        out = torch.cat([real(h, *a, **k) for h in x.chunk(2)])
        with torch.no_grad():
            whole = real(x, *a, **k)
            seen.append(float((out - whole).abs().max()
                              / whole.abs().max().clamp_min(1e-30)))
        return out

    with patched(F, "conv2d", conv2d):
        yield


def halves_summary(seen):
    return {"calls": len(seen), "differ": sum(v > 0 for v in seen),
            "max_rel": max(seen, default=0.0)}


class ConcatShards:
    """One process's view of a `world`-process run's sharded `Loader`s: each
    batch is the processes' batches concatenated, rank 0's rows first.
    Takes `Loader`'s arguments, `batch_size` being the global batch; stands
    in for a CLI's `Loader` in the one-process run that the two ranks are
    held to."""

    def __init__(self, dataset, batch_size, world=2, shard_index=0,
                 num_shards=1, **kw):
        from hifidiff_tpu_torch.data.core import Loader

        self.parts = [Loader(dataset, batch_size // world, shard_index=r,
                             num_shards=world, **kw) for r in range(world)]

    def __len__(self):
        return len(self.parts[0])

    @property
    def epoch(self):
        return self.parts[0].epoch

    @epoch.setter
    def epoch(self, epoch):
        for part in self.parts:
            part.epoch = epoch

    def __iter__(self):
        for batches in zip(*self.parts):
            yield {k: np.concatenate([b[k] for b in batches])
                   for k in batches[0]}


def dp_cli_argv(who, root, batch):
    """A training CLI's argv for phase 17 at `batch` a process, writing its
    log, checkpoints and grids into `root`."""
    argv = DP_CLI[who][1] + ["--seed", str(SEED), "--name", "dp",
                             "--log-dir", root, "--batch-size", str(batch),
                             "--ckpt-dir", os.path.join(root, "ck")]
    return argv + (["--out-dir", root] if who == "train_refiner" else [])


def dp_cli_run(who, root):
    """The CLI's logged rows and the state of its latest checkpoint."""
    from hifidiff_tpu_torch.train.checkpoint import CheckpointManager

    with open(os.path.join(root, f"{DP_CLI[who][0]}.dp.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpt = CheckpointManager(os.path.join(root, "ck", "dp"), create=False)
    return rows, torch.load(ckpt.path(ckpt.latest_step()),
                            map_location="cpu", weights_only=False)["state"]


def dp_cli_readings(who, ranks_root, one_root):
    """The two ranks' run of a CLI against one process's: the logged train
    losses and val metrics (largest relative difference), the steps, and
    the checkpoint's trained entries (parameters and EMA: the share more
    than 5e-2 of a learning rate per update apart, or at a learning rate of
    0 the largest difference) and running statistics."""
    (got_rows, got), (want_rows, want) = (dp_cli_run(who, r)
                                          for r in (ranks_root, one_root))

    def logged(rows, key):
        return [r[key] for r in rows if key in r]

    def rel(key):
        a, b = logged(got_rows, key), logged(want_rows, key)
        if len(a) != len(b) or not b:
            return math.inf
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    vals = [k for k in ("val_psnr", "val_ssim", "val_loss")
            if logged(want_rows, k)]
    lr = DP_CLI[who][3]
    over = total = 0
    far = stats = 0.0
    for n, b in want["module"].items():
        a = got["module"][n]
        if n.endswith(("running_mean", "running_var")):
            stats = max(stats, float((a - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30)))
            continue
        if not b.is_floating_point():
            continue
        pairs = [(a, b)]
        if want["ema_params"] and n in want["ema_params"]:
            pairs.append((got["ema_params"][n], want["ema_params"][n]))
        for x, y in pairs:
            diff = (x - y).abs()
            if lr:
                diff = diff / (lr * want["step"])
                over += int((diff > DP_PARAM_LR).sum())
            total += diff.numel()
            far = max(far, float(diff.max()))
    out = {"steps": [got["step"], want["step"]],
           "train_losses": [logged(got_rows, "train_loss"),
                            logged(want_rows, "train_loss")],
           "val": {k: [logged(got_rows, k), logged(want_rows, k)]
                   for k in vals},
           "loss_rel": rel("train_loss"),
           "val_rel": max((rel(k) for k in vals), default=math.inf),
           "stats_rel": stats}
    if lr:
        out.update(param_share=over / max(total, 1), param_far_lr=far)
    else:
        out["param_abs"] = far
    return out


def dp_stack():
    """(refiner with the freeze mask, frozen CR, frozen VAE, IDC): phase 4's
    seeded perturbed stack and a seeded perturbed ResNet-50 IDC, float32 on
    the CPU."""
    from hifidiff_tpu_torch.models.idc import IDCEncoder
    from hifidiff_tpu_torch.random_weights import perturb_
    from hifidiff_tpu_torch.train import optim

    refiner, cr, vae = build_models()
    optim.apply_freeze_mask_(refiner, optim.refiner_freeze_mask(refiner))
    torch.manual_seed(SEED + 17)
    idc = perturb_(IDCEncoder(), torch.Generator().manual_seed(SEED + 17))
    return refiner, cr, vae, idc


def dp_batch(kind, i):
    """Step i's global batch (NCHW float32 on the CPU)."""
    rng = np.random.default_rng((SEED + 17, i, len(kind)))
    keys = ("lr", "gt") if kind == "refiner" else ("lr", "pos", "other")
    return {k: torch.from_numpy(rng.uniform(
        0, 1, (DP_BATCH[kind], 3, 128, 128)).astype(np.float32))
        for k in keys}


def dp_draws(i, dev):
    """What the refiner step draws from `seeded_generator(SEED + 17, i)`
    for the global batch, in its order: both posteriors' noise, the noise,
    the timesteps."""
    from hifidiff_tpu_torch.cli.common import seeded_generator

    g = seeded_generator(SEED + 17, i, dev)
    b = DP_BATCH["refiner"]
    normal = [torch.randn(b, 4, LATENT, LATENT, generator=g, device=dev)
              for _ in range(3)]
    return (*normal, torch.randint(0, 1000, (b,), generator=g, device=dev))


def dp_digest(state):
    """A digest of the bits of the state's parameters, buffers and EMA (an
    int64 sum of each tensor's words weighted by position, on the card)."""
    import hashlib

    ts = list(state.module.state_dict().values()) + list(
        (state.ema_params or {}).values())
    sums = []
    for t in ts:
        t = t.detach().contiguous().reshape(-1)
        w = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()]).long()
        mult = torch.arange(w.numel(), device=w.device) % 65521 * 2 + 1
        sums.append((w * mult).sum())
    return hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes()) \
        .hexdigest()[:16]


def dp_run(kind, stack, dev, group=None, rows=slice(None), maps=None,
           launches=None, collective=None, order=None, after_step=None):
    """DP_STEPS steps of the refiner or the IDC step ("idc64": in float64)
    on `rows` of each global batch, through `TrainState.create(...,
    group=group)`, the state's storage held in place across each step
    (`utils.checks.assert_in_place`); the
    refiner's draws from `seeded_generator(SEED + 17, i)` on the card (with
    `order`, a permutation of the global batch's rows, the batch and the
    same draws reordered and handed to the step). Returns the state and
    {"losses", "digests" after each step, "step_s", "grads" of the first
    step on the card}. With `maps` the maps that reached the kernels are
    counted into it (`recording`); with `launches` each step's kernel
    launches are appended; with `collective` each gradient all-reduce's ms
    are appended; `after_step(i, state)` runs after each step but the
    last."""
    import functools

    from hifidiff_tpu_torch.cli.common import seeded_generator
    from hifidiff_tpu_torch.ops import kernels
    from hifidiff_tpu_torch.train import optim, steps

    from hifidiff_tpu_torch.utils import checks

    refiner, cr, vae, idc = stack
    cr = copy.deepcopy(cr)
    dtype = torch.float64 if kind == "idc64" else torch.float32
    if kind == "idc64":
        cr = RowwiseCast(cr, dtype)
    if kind == "refiner":
        refiner, vae = copy.deepcopy(refiner), copy.deepcopy(vae)
        module, ema = refiner, DP_EMA
        step = steps.make_refiner_train_step(cr, vae, device=dev)
        make = functools.partial(optim.adamw_cosine, warmup_steps=0,
                                 total_steps=1000)
    else:
        module, ema = copy.deepcopy(idc).to(dtype), 0.0
        step = steps.make_idc_train_step(cr, device=dev)
        make = optim.adam
    state = steps.TrainState.create(module, make, ema_decay=ema, device=dev,
                                    group=group)
    grads, applied = {}, state.optimizer.step

    def spy(*a, **k):
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in module.named_parameters()
                          if p.grad is not None})
        return applied(*a, **k)

    state.optimizer.step = spy
    real = steps.all_reduce_gradients

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        collective.append((time.perf_counter() - t0) * 1e3)
        return out

    out = {"losses": [], "digests": [], "step_s": []}
    with contextlib.ExitStack() as stack_:
        if maps is not None:
            seen = stack_.enter_context(recording(training=True))
        if collective is not None:
            stack_.enter_context(patched(steps, "all_reduce_gradients",
                                         timed))
        for i in range(DP_STEPS):
            full = dp_batch("idc" if kind == "idc64" else kind, i)
            if order is not None:
                full = {k: v[order] for k, v in full.items()}
            batch = {k: v[rows].to(dev, dtype) for k, v in full.items()}
            storage = checks.storage_of(state)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind != "refiner":
                _, m = step(state, batch)
            elif order is None:
                _, m = step(state, batch, generator=seeded_generator(
                    SEED + 17, i, dev))
            else:
                _, m = step(state, batch, *(d[order.to(dev)]
                                            for d in dp_draws(i, dev)))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            checks.assert_in_place(state, storage)
            if launches is not None:
                launches.append({k: n for k, n in kernels.LAUNCHES.items()
                                 if n})
            out["losses"].append(float(m["loss"]))
            out["digests"].append(dp_digest(state))
            if after_step is not None and i + 1 < DP_STEPS:
                after_step(i, state)
    if maps is not None:
        for kernel, counts in seen.items():
            maps[kernel].update(counts)
    out["grads"] = grads
    return state, out


def dp_captured(stack, dev, group=None):
    """The IDC step (EMA) on the first DP_CAPTURE_ROWS rows of each global
    batch, captured as CUDA graphs (`train/graphs.py`) through
    `TrainState.create(..., group=group)` on a capturable optimizer: the
    gradient all-reduce inside the graph, DP_STEPS calls (the first warms
    up and captures, the others replay). Returns (losses, digests after
    each call)."""
    from hifidiff_tpu_torch.train import graphs, optim, steps

    cr, idc = (copy.deepcopy(m) for m in (stack[1], stack[3]))
    step = steps.make_idc_train_step(cr, device=dev)
    state = steps.TrainState.create(
        idc, functools.partial(optim.adam, capturable=True),
        ema_decay=DP_EMA, device=dev, group=group)
    batches = [{k: v[:DP_CAPTURE_ROWS].to(dev)
                for k, v in dp_batch("idc", i).items()}
               for i in range(DP_STEPS)]
    cap = graphs.capture_train_step(step, state, batches[0])
    losses, digests = [], []
    for batch in batches:
        _, m = cap.run(batch)
        losses.append(float(m["loss"]))
        digests.append(dp_digest(state))
    return losses, digests


def dp_keep(kept, i, state):
    """`after_step` of the one-process IDC run: keep a copy of its module's
    state after step i."""
    kept[i] = {k: v.clone() for k, v in state.module.state_dict().items()}


def dp_align(kept, group, i, state):
    """`after_step` that sets the module's parameters and buffers to the
    one-process run's after step i (`kept`, held by rank 0 of `group`,
    which broadcasts them; `group` None: this process holds them)."""
    with torch.no_grad():
        for k, v in state.module.state_dict().items():
            if k in kept.get(i, {}):
                v.copy_(kept[i][k])
            if group is not None:
                torch.distributed.broadcast(v, 0, group=group)


def dp_readings(got_state, got, ref_state, ref, updates=DP_STEPS):
    """How far `got` is from `ref` (both from `dp_run`, `updates` optimizer
    steps apart: DP_STEPS, or 1 where the runs were aligned after each
    step), with the worst tensors: phase 17's readings (see the constants
    above)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       ref["losses"]))
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    floor = DP_GRAD_FLOOR * top
    noise, errs = set(), {}
    for n, g in ref["grads"].items():
        mine = got["grads"][n]
        size = max(float(mine.abs().max()), float(g.abs().max()))
        if size < floor:
            noise.add(n)
            continue
        errs[n] = float((mine - g).abs().max()) / max(float(g.abs().max()),
                                                      floor)
    lr = ref_state.optimizer.param_groups[0]["lr"]
    mine_sd, ref_sd = got_state.module.state_dict(), \
        ref_state.module.state_dict()
    over = total = 0
    far, by_tensor = 0.0, {}
    for n in ref["grads"]:
        if n in noise:
            continue
        pairs = [(mine_sd[n], ref_sd[n])]
        if ref_state.ema_params is not None:
            pairs.append((got_state.ema_params[n], ref_state.ema_params[n]))
        for a, b in pairs:
            diff = (a - b).abs() / (lr * updates)
            k = int((diff > DP_PARAM_LR).sum())
            over += k
            total += diff.numel()
            far = max(far, float(diff.max()))
            by_tensor[n] = by_tensor.get(n, 0) + k
    frozen = max((float((mine_sd[n] - p).abs().max())
                  for n, p in ref_sd.items() if n not in ref["grads"]
                  and p.is_floating_point()
                  and not n.endswith(("running_mean", "running_var"))),
                 default=0.0)
    stats = max((float((mine_sd[n] - b).abs().max()
                       / b.abs().max().clamp_min(1e-30))
                 for n, b in ref_sd.items()
                 if n.endswith(("running_mean", "running_var"))),
                default=0.0)
    dot = sum(float((got["grads"][n].double() * g.double()).sum())
              for n, g in ref["grads"].items())
    norms = [math.sqrt(sum(float(t.double().square().sum())
                           for t in d["grads"].values())) for d in (got, ref)]
    worst_g = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    worst_p = sorted(by_tensor.items(), key=lambda kv: -kv[1])[:4]
    return {"loss_rel": loss_rel, "grad_rel": max(errs.values()),
            "grad_cosine": dot / (norms[0] * norms[1]),
            "noise_tensors": len(noise), "grad_tensors": len(ref["grads"]),
            "param_share": over / max(total, 1), "param_far_lr": far,
            "frozen": frozen, "stats_rel": stats,
            "worst_grads": [[n, e, float(ref["grads"][n].abs().max()) / top]
                            for n, e in worst_g],
            "worst_params": worst_p}


def dp_child(rank, work):
    """One of phase 17's two ranks on the card (gloo): the refiner and IDC
    steps (and the IDC's float64 witness) on its half of each batch, the
    refiner again on cuDNN, `test_refiner` at batch 1, then `train_refiner`
    and `pretrain_idc` by their `main`; rank 0 also runs the steps without a
    group on the whole batches, on them shuffled, and the witnesses, and
    takes the readings. Writes rank<rank>.json into `work`."""
    import functools

    from hifidiff_tpu_torch.cli import (pretrain_idc, test_refiner,
                                        train_refiner)
    from hifidiff_tpu_torch.parallel import maybe_initialize
    from hifidiff_tpu_torch.parallel.distributed import barrier

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=2, rank=rank, backend="gloo", local_rank=0,
                     device="cuda")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    stack = dp_stack()
    out = {"build_s": time.perf_counter() - t0, "kinds": {}}
    group = torch.distributed.group.WORLD
    with deterministic() as warned:
        for kind in ("refiner", "idc", "idc64"):
            b = DP_BATCH[kind] // 2
            maps = {k: collections.Counter() for k in KERNELS}
            launches, collective = [], []
            align, updates = None, DP_STEPS
            if kind != "refiner":
                # ROADMAP §C2: the IDC's float32 gradient is ill-conditioned
                # and Adam's first updates are sign-like, so each run is set
                # to the one-process run's state after every step (rank 0
                # runs that first and broadcasts it)
                aligned = {}
                if rank == 0:
                    ref_state, ref = dp_run(kind, stack, dev,
                                            after_step=functools.partial(
                                                dp_keep, aligned))
                align = functools.partial(dp_align, aligned, group)
                updates = 1
            t0 = time.perf_counter()
            state, got = dp_run(kind, stack, dev, group,
                                slice(rank * b, (rank + 1) * b),
                                maps if kind != "idc64" else None,
                                launches, collective, after_step=align)
            res = {"seconds": time.perf_counter() - t0,
                   "step_s": got["step_s"], "losses": got["losses"],
                   "digests": got["digests"], "launches": launches,
                   "collective_ms": collective,
                   "grad_bytes": sum(g.numel() * g.element_size()
                                     for g in got["grads"].values()),
                   "maps": {k: [[list(s), n] for s, n in c.items()]
                            for k, c in maps.items() if c}}
            barrier()
            if rank == 0:
                if kind == "refiner":
                    ref_state, ref = dp_run(kind, stack, dev)
                res["reference_step_s"] = ref["step_s"]
                res["reference_digests"] = ref["digests"]
                res["reference_losses"] = ref["losses"]
                res["readings"] = dp_readings(state, got, ref_state, ref,
                                              updates)
                del state, got
                torch.cuda.empty_cache()
                res["baseline_losses"] = res["baseline"] = None
                if kind != "idc64":     # its limits are float64 rounding's
                    shuffled = torch.from_numpy(np.random.default_rng(
                        SEED + 17).permutation(DP_BATCH[kind]))
                    base_state, base = dp_run(
                        kind, stack, dev, order=shuffled,
                        after_step=align and functools.partial(
                            dp_align, aligned, None))
                    res["baseline_losses"] = base["losses"]
                    res["baseline"] = dp_readings(base_state, base,
                                                  ref_state, ref, updates)
                    del base_state, base
                if kind == "idc":
                    # the cause of the float32 gap: BatchNorm's statistics
                    # rounded otherwise, in one process on the same rows
                    with bn_by_formula():
                        w_state, w = dp_run(kind, stack, dev,
                                            after_step=functools.partial(
                                                dp_align, aligned, None))
                    res["bn_formula"] = dp_readings(w_state, w, ref_state,
                                                    ref, updates)
                    del w_state, w
                del ref_state, ref
            else:
                del state, got
            torch.cuda.empty_cache()
            barrier()
            out["kinds"][kind] = res
    out["nondeterministic_ops"] = warned
    # the refiner on cuDNN's convolutions, and the witness of its gap
    b = DP_BATCH["refiner"] // 2
    with deterministic(cudnn=True):
        state, got = dp_run("refiner", stack, dev, group,
                            slice(rank * b, (rank + 1) * b))
        barrier()
        if rank == 0:
            # one process: as is; its convolutions in halves; BatchNorm by
            # the data-parallel formula; both
            ref_state, ref = dp_run("refiner", stack, dev)
            seen, found = [], {}
            for label, halves, formula in (
                    ("halves", True, False), ("formula", False, True),
                    ("formula_halves", True, True)):
                with contextlib.ExitStack() as ctx:
                    if halves:
                        ctx.enter_context(conv_in_halves(
                            DP_BATCH["refiner"], seen if not formula
                            else []))
                    if formula:
                        ctx.enter_context(bn_by_formula())
                    w_state, w = dp_run("refiner", stack, dev)
                found[f"{label}_vs_one"] = dp_readings(w_state, w,
                                                       ref_state, ref)
                found[f"ranks_vs_{label}"] = dp_readings(state, got,
                                                         w_state, w)
                del w_state, w
                torch.cuda.empty_cache()
            out["cudnn"] = {
                "ranks_vs_one": dp_readings(state, got, ref_state, ref),
                **found, "conv_halves": halves_summary(seen)}
            del ref_state, ref
        del state, got
        torch.cuda.empty_cache()
    if rank == 0:
        seen = []
        with deterministic(), conv_in_halves(DP_BATCH["refiner"], seen):
            dp_run("refiner", stack, dev)
        out["cudnn"]["conv_halves_without_cudnn"] = halves_summary(seen)
        torch.cuda.empty_cache()
    barrier()
    t0 = time.perf_counter()
    out["test_refiner"] = test_refiner.main(DP_EVAL_ARGV
                                            + ["--batch-size", "1"])
    out["test_refiner_s"] = time.perf_counter() - t0
    # the training CLIs on the two ranks (the parent runs the one-process
    # runs they are held to)
    del stack
    out["cli_s"] = {}
    with deterministic():
        for who, cli in (("train_refiner", train_refiner),
                         ("pretrain_idc", pretrain_idc)):
            t0 = time.perf_counter()
            cli.main(dp_cli_argv(who, os.path.join(work, f"{who}_ranks"),
                                 DP_CLI[who][2] // 2))
            out["cli_s"][who] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    out["peak_gb"] = [torch.cuda.max_memory_allocated() / 1e9,
                      torch.cuda.max_memory_reserved() / 1e9]
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_hold(what, got, limits, base=None):
    """Fail for each reading of `got` past its limit (`grad_cosine`: below
    it)."""
    for key, limit in limits.items():
        if not (got[key] >= limit if key == "grad_cosine"
                else got[key] <= limit):
            fail(f"{what}: {key} {got[key]:.3e} past its limit {limit:.3e}"
                 + (f" (the shuffled batch reads {base[key]:.3e})"
                    if base else ""))


def check_data_parallel(dev, g, stats, smi):
    """Phase 17 (see the constants above), in three parts, as a generator,
    so that the caller's other work runs while the ranks run: the first
    `next` runs (a) here; the second starts (b)'s two ranks; the third runs
    (c) and the one-process runs of the training CLIs here, waits for the
    ranks, takes the readings and yields (its numbers for the log, each
    kind's launches of one step on a rank). Its ranks share the card with
    whatever the caller runs in between: their times are for the record.
    (a) holds two refiner states, rank 0 three: (a) runs alone."""
    import tempfile
    import threading

    from hifidiff_tpu_torch.cli import (pretrain_idc, serve, test_refiner,
                                        train_refiner)
    from hifidiff_tpu_torch.parallel import maybe_initialize

    report, procs = {}, []
    with tempfile.TemporaryDirectory() as work:
        try:
            # (a) world size 1 on NCCL, here
            t_start = time.perf_counter()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            maybe_initialize(init_method=f"file://{work}/a_store",
                             world_size=1, rank=0, backend="nccl",
                             local_rank=0, device="cuda")
            try:
                stack = dp_stack()
                group = torch.distributed.group.WORLD
                ref_digests, wants = {}, {}
                frozen_cr = copy.deepcopy(stack[1]).requires_grad_(False)
                with deterministic() as warned:
                    for kind in ("refiner", "idc"):
                        wants[kind] = expected_train_launches(
                            stack[0] if kind == "refiner" else stack[3],
                            frozen_cr)
                        t0 = time.perf_counter()
                        s1, one = dp_run(kind, stack, dev, group)
                        s0, none = dp_run(kind, stack, dev)
                        same = one["losses"] == none["losses"] \
                            and one["digests"] == none["digests"] and all(
                                torch.equal(a, b) for a, b in zip(
                                    s1.module.state_dict().values(),
                                    s0.module.state_dict().values()))
                        ref_digests[kind] = none["digests"]
                        log(f"phase 17 (a) {kind}: batch {DP_BATCH[kind]}, "
                            f"{DP_STEPS} steps in a world-1 NCCL group vs no"
                            f" group: losses {one['losses']} / "
                            f"{none['losses']}, digests {one['digests']} / "
                            f"{none['digests']}, bit for bit {same} "
                            f"({time.perf_counter() - t0:.1f} s) [{smi}]")
                        if not same:
                            fail(f"phase 17 (a) {kind}: the world-1 NCCL run "
                                 "is not the run without a group bit for "
                                 "bit; "
                                 + json.dumps(dp_readings(s1, one, s0, none)))
                        del s1, s0, one, none
                        torch.cuda.empty_cache()
                    # the IDC step captured as CUDA graphs, its gradient
                    # all-reduce inside the graph
                    t0 = time.perf_counter()
                    one, none = (dp_captured(stack, dev, grp)
                                 for grp in (group, None))
                    log(f"phase 17 (a) captured IDC step: batch "
                        f"{DP_CAPTURE_ROWS}, {DP_STEPS} replays in a world-1 "
                        f"NCCL group vs no group: losses {one[0]} / "
                        f"{none[0]}, digests {one[1]} / {none[1]}, bit for "
                        f"bit {one == none} ({time.perf_counter() - t0:.1f} "
                        f"s) [{smi}]")
                    if one != none:
                        fail("phase 17 (a): the captured world-1 NCCL step "
                             "is not the captured step without a group")
                log(f"phase 17: operators without a deterministic algorithm: "
                    f"{warned or 'none'}")
                del stack, frozen_cr
            finally:
                # an NCCL group left at exit holds the process for minutes
                torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            report["a_s"] = time.perf_counter() - t_start
            yield
            # (b) the two ranks, beside whatever the caller runs next; their
            # caching allocators on expandable segments, so that what they
            # reserve stays near what they hold (rank 0 reserved 59 GB
            # without them on an H100)
            t_go = time.perf_counter()
            env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
                   **os.environ}
            for r in range(2):     # their output into files: nothing reads
                # a pipe while the caller works
                with open(os.path.join(work, f"rank{r}.log"), "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--dp-child", str(r), work], stdout=f,
                        stderr=subprocess.STDOUT, env=env))
            yield
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            t_start = time.perf_counter()
            # (c) one process: test_refiner at batch 2, held to the two
            # ranks below
            t0 = time.perf_counter()
            single = test_refiner.main(DP_EVAL_ARGV + ["--batch-size", "2"])
            report["test_refiner_1_rank_s"] = time.perf_counter() - t0
            # the server over every local card (--mesh-devices 0): the one
            # card
            cfg = serve.Config(port=0, mesh_devices=0, batch=2, buckets="1",
                               num_inference_steps=2, seed=SEED)
            t0 = time.perf_counter()
            httpd, batcher = serve.create_server(cfg)
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                run = batcher.run_fn
                replays = run.sampler.replays
                img = np.random.default_rng(SEED).integers(
                    0, 256, (128, 128, 3), np.uint8)
                face = _post_raw(*httpd.server_address[:2], img)
                ok = run.devices == [torch.device("cuda", 0)] \
                    and run.sampler.replays == replays + 1 \
                    and int(face.max()) > int(face.min())
                log(f"phase 17 (c) serve --mesh-devices 0: devices "
                    f"{run.devices}, buckets {run.buckets}, one face served "
                    f"as a replay {ok} ({time.perf_counter() - t0:.1f} s "
                    "with the cold start)")
                if not ok:
                    fail("phase 17 (c): serve --mesh-devices 0 did not "
                         "serve on the one card from its graphs")
            finally:
                httpd.shutdown()
                batcher.stop()
            del run, batcher, httpd
            torch.cuda.empty_cache()
            # the one-process runs of the training CLIs, on the ranks'
            # batches concatenated
            t0 = time.perf_counter()
            with deterministic():
                for who, cli in (("train_refiner", train_refiner),
                                 ("pretrain_idc", pretrain_idc)):
                    with patched(cli, "Loader", ConcatShards):
                        cli.main(dp_cli_argv(
                            who, os.path.join(work, f"{who}_one"),
                            DP_CLI[who][2]))
                    torch.cuda.empty_cache()
            report["cli_one_process_s"] = time.perf_counter() - t0
            for p in procs:
                p.wait(timeout=DP_TIMEOUT)
            report["ranks_s"] = time.perf_counter() - t_go
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    out = f.read()
                fail(f"phase 17 (b) rank {r} failed (rc {p.returncode}): "
                     + out[-3000:])
                yield report, {}
                return
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        clis = {who: dp_cli_readings(who,
                                     os.path.join(work, f"{who}_ranks"),
                                     os.path.join(work, f"{who}_one"))
                for who in DP_CLI}
    seen = {k: collections.Counter() for k in KERNELS}
    per_step = {}
    for kind in ("refiner", "idc", "idc64"):
        a, b = (rank["kinds"][kind] for rank in ranks)
        got, base = a["readings"], a["baseline"]
        ms = a["collective_ms"]
        log(f"phase 17 (b) {kind}: 2 ranks x {DP_BATCH[kind] // 2} over gloo "
            f"on the card: losses {a['losses']} (rank 1 {b['losses']}), one "
            f"process {a['reference_losses']}, one process on the shuffled "
            f"batch {a['baseline_losses']}; two ranks vs one process "
            f"{json.dumps(got)}; shuffled vs one process {json.dumps(base)}"
            f"; gradient all-reduce {a['grad_bytes'] / 1e9:.3f} GB a step "
            f"in {statistics.mean(ms):.1f} ms (mean of {len(ms)} steps; gloo "
            f"through the host, the test rig's rate, not NCCL's); a rank's "
            f"steps {a['step_s']} s, one process's "
            f"{a['reference_step_s']} s; launches of a step on a rank "
            f"{a['launches'][0]} [{smi}]")
        if kind == "idc":
            log("phase 17 (b) idc, the cause of its gap: one process with "
                "BatchNorm's statistics by the data-parallel formula "
                "(without a group) vs torch's own, on the same rows "
                + json.dumps(a["bn_formula"]))
        report[kind] = {"losses": a["losses"],
                        "reference_losses": a["reference_losses"],
                        **{k: v for k, v in got.items()
                           if not k.startswith("worst")},
                        "baseline": base and {
                            k: v for k, v in base.items()
                            if not k.startswith("worst")},
                        "collective_ms_per_step": statistics.mean(ms),
                        "grad_gb": a["grad_bytes"] / 1e9,
                        "step_s_rank": a["step_s"],
                        "step_s_one_process": a["reference_step_s"]}
        if a["digests"] != b["digests"]:
            fail(f"phase 17 (b) {kind}: the ranks' states differ after a "
                 f"step: {a['digests']} vs {b['digests']}")
        if kind in ref_digests \
                and a["reference_digests"] != ref_digests[kind]:
            fail(f"phase 17 (b) {kind}: rank 0's one-process run is not "
                 f"(a)'s: {a['reference_digests']} vs {ref_digests[kind]}")
        dp_hold(f"phase 17 (b) {kind}: two ranks vs one process", got,
                DP_LIMITS[kind], base)
        if got["frozen"] != 0 or (
                base and got["noise_tensors"] > base["noise_tensors"]):
            fail(f"phase 17 (b) {kind}: frozen parameters moved, or more "
                 f"tensors of rounding noise than the shuffled batch: "
                 f"{got}")
        if kind == "idc64":
            continue
        want = wants[kind]
        for rank in (a, b):
            for step_launches in rank["launches"]:
                if {k: step_launches.get(k, 0) for k in want} != want:
                    fail(f"phase 17 (b) {kind}: a step launched "
                         f"{step_launches}, the module tree gives {want}")
        per_step[kind] = a["launches"][0]
        for rank in (a, b):
            for kernel, items in rank["maps"].items():
                for shape, n in items:
                    seen[kernel][tuple(shape)] += n
    cudnn = ranks[0]["cudnn"]
    log("phase 17 (b) refiner on cuDNN's deterministic convolutions: two "
        "ranks vs one process " + json.dumps(cudnn["ranks_vs_one"]))
    for label, what in (("halves", "its 32-row convolutions made as two "
                         "16-row calls"),
                        ("formula", "BatchNorm's statistics by the "
                         "data-parallel formula"),
                        ("formula_halves", "both")):
        log(f"phase 17 (b) refiner on cuDNN, the witness: one process with "
            f"{what} vs one process "
            + json.dumps(cudnn[f"{label}_vs_one"]) + "; the two ranks vs it "
            + json.dumps(cudnn[f"ranks_vs_{label}"]))
    log("phase 17 (b) refiner: the 16-row calls vs the 32-row call, with "
        "cuDNN " + json.dumps(cudnn["conv_halves"]) + ", without "
        + json.dumps(cudnn["conv_halves_without_cudnn"]) + f" [{smi}]")
    report["refiner_on_cudnn"] = {
        k: ({n: x for n, x in v.items() if not n.startswith("worst")}
            if k != "conv_halves" and k != "conv_halves_without_cudnn"
            else v) for k, v in cudnn.items()}
    dp_hold("phase 17 (b) refiner on cuDNN: two ranks vs one process",
            cudnn["ranks_vs_one"], DP_CUDNN_LIMITS)
    # the witness held: the 16-row convolutions alone move one process as
    # far as the two ranks are from it, BatchNorm's formula a tenth or less
    for key in ("loss_rel", "grad_rel", "param_share"):
        gap = cudnn["ranks_vs_one"][key]
        if not cudnn["halves_vs_one"][key] >= gap / 2 \
                or not cudnn["formula_vs_one"][key] <= gap / 10:
            fail(f"phase 17 (b) refiner on cuDNN: the witness no longer "
                 f"accounts for the gap's {key} {gap:.3e}: the convolutions "
                 f"in halves read {cudnn['halves_vs_one'][key]:.3e} (at "
                 f"least half), BatchNorm's formula "
                 f"{cudnn['formula_vs_one'][key]:.3e} (a tenth or less)")
    for who, r in clis.items():
        log(f"phase 17 (b) {who} by its main, 2 ranks x "
            f"{DP_CLI[who][2] // 2} vs one process x {DP_CLI[who][2]} on "
            f"the concatenated batches: {json.dumps(r)} (the ranks "
            f"{ranks[0]['cli_s'][who]:.1f} s)")
        if r["steps"][0] != r["steps"][1] or not r["train_losses"][0]:
            fail(f"phase 17 (b) {who}: steps {r['steps']}, losses "
                 f"{r['train_losses']}")
        dp_hold(f"phase 17 (b) {who}: two ranks vs one process", r,
                DP_CLI_LIMITS[who])
    report["clis"] = {who: {k: v for k, v in r.items()
                            if k.endswith(("_rel", "_share", "_abs",
                                           "_lr"))}
                      for who, r in clis.items()}
    report["cli_s"] = ranks[0]["cli_s"]
    # each rank's peak of the card's memory, held and reserved
    report["ranks_peak_gb"] = [r["peak_gb"] for r in ranks]
    log("phase 17 (b): operators without a deterministic algorithm on the "
        f"ranks: {ranks[0]['nondeterministic_ops'] or 'none'}; maps that "
        "reached the kernels on either rank: "
        + json.dumps({k: {str(s): n for s, n in c.items()}
                      for k, c in seen.items() if c}))
    check_recorded_shapes(dev, g, stats, seen, phase="phase 17")
    # (c) the one process's test_refiner at batch 2 against the two ranks
    got = ranks[0]["test_refiner"]
    rel = max(abs(got[k] - single[k]) / abs(single[k]) for k in single)
    log(f"phase 17 (c) test_refiner (f32, DDIM-10, 8 procedural faces): 2 "
        f"ranks x batch 1 {got} ({ranks[0]['test_refiner_s']:.1f} s), 1 "
        f"process x batch 2 {single} ({report['test_refiner_1_rank_s']:.1f} "
        f"s): rel {rel:.2e} (limit {DP_EVAL_REL:.0e})")
    report["test_refiner_rel"] = rel
    if ranks[1]["test_refiner"] != got or not rel <= DP_EVAL_REL:
        fail(f"phase 17 (c) test_refiner: 2 ranks {got} / "
             f"{ranks[1]['test_refiner']} vs 1 process {single}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # this process's own seconds in the phase, the caller's work between
    # the parts left out
    report["seconds"] = report["a_s"] + time.perf_counter() - t_start
    yield report, per_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from hifidiff_tpu_torch.models.refiner import quantize_denoiser_
    from hifidiff_tpu_torch.nn import layers, naf
    from hifidiff_tpu_torch.ops import kernels, naf_block, norm, quant
    from hifidiff_tpu_torch.random_weights import amplify_naf_blocks_
    from hifidiff_tpu_torch.vae import model as vae_model

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    report_build(lib.build_log)

    # -- 3. kernels vs plain at the paths' fixed shapes ---------------------
    stats = Stats()
    g = torch.Generator(device=dev).manual_seed(SEED)
    check_ln_film(dev, g, stats)
    check_warp(dev, g, stats)
    chains = check_fused_block(dev, g, stats)
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] kernel checks done")

    # -- 7. the backward kernels vs plain at the training paths' shapes -----
    check_ln_film_bwd(dev, g, stats)
    check_warp_bwd(dev, g, stats)
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] backward kernel checks "
        "done")

    # -- 4. full width, f32, card vs host CPU -------------------------------
    t0 = time.perf_counter()
    cpu_models = build_models()
    log(f"models built and perturbed on the CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    inputs = (torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3),
                                            dtype=np.uint8)),
              *(torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(
                  np.float32)) for _ in range(2)))
    on_card = tuple(t.to(dev) for t in inputs)

    def card_run(models, dtype=torch.float32, **options):
        models = [copy.deepcopy(m).to(dtype) for m in models]
        run = run_stages(make_sampler(models, dev, **options), *on_card,
                         denoiser=models[0].denoiser
                         if options.get("fuse_small_naf") else None)
        torch.cuda.synchronize()
        return run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_g = card_run(cpu_models)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref_c = run_stages(make_sampler(cpu_models, "cpu"), *inputs)
    log(f"host CPU plain run (batch 2, f32, {STEPS} steps): "
        f"{time.perf_counter() - t0:.1f} s")
    limits = (LATENT_REL_TOL, FACE_LEVEL_TOL)
    if disagreement("e2e f32 card vs CPU", run_g, ref_c, *limits):
        fail("default path: card and CPU runs disagree")

    # controls: paths that are wrong in the FiLM or in precision must fail
    with patched(layers, "ln_film", film_ignored):
        control = card_run(cpu_models)
    if not disagreement("control, f32 card with the FiLM left out",
                        control, ref_c, *limits):
        fail("the e2e check passes a path without FiLM")
    control = card_run(cpu_models, torch.bfloat16)
    if not disagreement("control, bf16 on the card", control, ref_c,
                        *limits):
        fail("the e2e check passes a bf16 path")
    del control, run_g
    log(f"[{time.perf_counter() - t_start:.0f} s] default path checked")

    # -- 5. int8 + fused blocks + fused GN+SiLU, batch 2 --------------------
    both = dict(fuse_small_naf=True, fused_gn_silu=True)
    cpu_q = copy.deepcopy(cpu_models)
    for blk in fusable_blocks(cpu_q[0].denoiser):   # the blocks under test
        amplify_naf_blocks_(blk)
    n_q = quantize_denoiser_(cpu_q[0])
    log(f"quantize_denoiser_: {n_q} layers of the denoiser hold int8 weights")
    t0 = time.perf_counter()
    ref_q = run_stages(make_sampler(cpu_q, "cpu", **both), *inputs)
    log(f"host CPU plain run, int8 + fused configuration (batch 2, f32, "
        f"{STEPS} steps): {time.perf_counter() - t0:.1f} s")
    kernels.reset_launches()
    run_q = card_run(cpu_q, torch.bfloat16, **both)
    log(f"launches of the batch-2 call: {dict(kernels.LAUNCHES)}")
    if disagreement("e2e int8 + fused: bf16 card (kernels) vs f32 CPU "
                    "(plain)", run_q, ref_q, *INT8_LIMITS, BRANCH_TOL):
        fail("int8 + fused path: card and CPU runs disagree, or a fused "
             "block and its plain version")

    def gn_plain(x, w, b, groups, eps, fused=False):
        return norm.group_norm_silu_plain(x, w, b, groups, eps)

    with patched(naf, "fused_cnaf_block_small",
                 naf_block.fused_cnaf_block_small_plain), \
            patched(quant, "matmul_w8", quant.matmul_w8_plain), \
            patched(vae_model, "group_norm_silu", gn_plain):
        kernels.reset_launches()
        plain_q = card_run(cpu_q, torch.bfloat16, **both)
    if any(kernels.LAUNCHES[k] for k in ("cnaf_small", "matmul_w8",
                                         "group_norm_silu")):
        fail("the plain-version run launched a kernel it should have "
             "replaced")
    disagreement("for the record: bf16 card (plain) vs f32 CPU (plain)",
                 plain_q, ref_q, *INT8_LIMITS)
    if disagreement("e2e int8 + fused: bf16 card, kernels vs plain versions",
                    run_q, plain_q, *INT8_LIMITS):
        fail("int8 + fused path: the kernels and their plain versions "
             "disagree on the card")

    def packed_centre_tap_only(**kw):
        return centre_tap_only(naf_block.pack_cnaf_block(**kw))

    with patched(naf, "pack_cnaf_block", packed_centre_tap_only):
        control = card_run(cpu_q, torch.bfloat16, **both)
    if not disagreement("control, position mix cut to its centre tap, vs "
                        "plain versions", control, plain_q, *INT8_LIMITS,
                        BRANCH_TOL):
        fail("the int8 + fused check passes a block without its "
             "off-centre taps")

    def no_scale(x, wq, scale, kernel=quant.matmul_w8):
        return kernel(x, wq, torch.ones_like(scale))

    with patched(quant, "matmul_w8", no_scale):
        control = card_run(cpu_q, torch.bfloat16, **both)
    if not disagreement("control, matmul_w8's column scales left out, vs "
                        "plain versions", control, plain_q, *INT8_LIMITS,
                        BRANCH_TOL):
        fail("the int8 + fused check passes a matmul_w8 without its "
             "column scales")
    del plain_q
    # the cached sampler on the same configuration: the fused blocks run in
    # both halves (enc3 and the middle blocks when the cache is refreshed,
    # dec0 in every step)
    t0 = time.perf_counter()
    ref_qc = run_stages(make_sampler(cpu_q, "cpu", cache_interval=2, **both),
                        *inputs)
    log(f"host CPU plain run, int8 + fused, cache_interval=2: "
        f"{time.perf_counter() - t0:.1f} s")
    run_qc = card_run(cpu_q, torch.bfloat16, cache_interval=2, **both)
    if disagreement("e2e int8 + fused, cache_interval=2: bf16 card (kernels) "
                    "vs f32 CPU (plain)", run_qc, ref_qc, *INT8_LIMITS,
                    BRANCH_TOL):
        fail("int8 + fused path, cache_interval=2: card and CPU runs "
             "disagree, or a fused block and its plain version")
    if not disagreement("control, the uncached int8 + fused run on the card "
                        "vs the cached CPU run", run_q, ref_qc,
                        *INT8_LIMITS):
        fail("the cached int8 + fused check passes the uncached run")
    del control, run_q, run_qc, ref_qc
    log(f"[{time.perf_counter() - t_start:.0f} s] int8 + fused path checked")

    # -- 10. the other samplers and options, f32, card vs host CPU ---------
    check_new_paths(cpu_models, dev, inputs, on_card)
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] new paths checked")

    # -- 8. full-width CR and refiner train steps, f32, card vs host CPU ----
    from hifidiff_tpu_torch.ops import warp as warp_ops
    rng_t = np.random.default_rng(SEED + 1)
    train_in = [train_inputs(rng_t, CHECK_BATCH) for _ in range(3)]

    def no_dcoef(g, x, coef, need_dx=True, need_dcoef=True,
                 real=warp_ops.warp_bwd):
        dx, dcoef = real(g, x, coef, need_dx, need_dcoef)
        return dx, None if dcoef is None else torch.zeros_like(dcoef)

    def no_dfilm(g, x, w, b, scale, eps=1e-6, need_wb=True,
                 real=norm.ln_film_bwd):
        dx, dw, db, dscale, dshift = real(g, x, w, b, scale, eps, need_wb)
        return dx, dw, db, torch.zeros_like(dscale), torch.zeros_like(dshift)

    dev_models = [copy.deepcopy(m).to(dev) for m in cpu_models]
    for kind, module, attr, wrong, what in (
            ("cr", warp_ops, "warp_bwd", no_dcoef, "dcoef zeroed"),
            ("refiner", norm, "ln_film_bwd", no_dfilm,
             "dscale and dshift zeroed")):
        kernels.reset_launches()
        card = run_train(kind, cpu_models, dev, train_in, 3)
        torch.cuda.synchronize()
        log(f"{kind} train steps on the card, batch {CHECK_BATCH}, f32: "
            f"launches of three steps: {dict(kernels.LAUNCHES)}")
        t0 = time.perf_counter()
        host = run_train(kind, cpu_models, "cpu", train_in, 3)
        log(f"host CPU plain run, three {kind} train steps (batch "
            f"{CHECK_BATCH}, f32): {time.perf_counter() - t0:.1f} s")
        if train_disagreement(f"{kind} train step, f32 card (kernels) vs "
                              "CPU (plain)", card, host, 3):
            fail(f"{kind} train step: card and CPU runs disagree")
        # the optimizer a captured step runs (its steps held to the
        # replays in `check_captured_steps`)
        capturable = run_train(kind, dev_models, dev, train_in, 3,
                               capturable=True)
        if train_disagreement(f"{kind} train step on a capturable "
                              "optimizer, f32 card (kernels) vs CPU (plain)",
                              capturable, host, 3):
            fail(f"{kind} train step on a capturable optimizer: card and "
                 "CPU runs disagree")
        del capturable
        with patched(module, attr, wrong):
            control = run_train(kind, cpu_models, dev, train_in, 1)
        if not train_disagreement(f"control, {kind} train step with {what}",
                                  control, host, 1):
            fail(f"the {kind} train-step check passes a backward with "
                 f"{what}")
        del card, host, control
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] train steps checked")
    check_captured_steps(dev_models, dev, smi)
    del dev_models
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] captured train steps "
        "checked")
    train_models = copy.deepcopy(cpu_models)   # float32, on the CPU

    # -- 6. batch 128, bf16, uint8 I/O, 50 steps, three configurations ------
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    del cpu_q   # its beta and gamma are not the default path's
    int8_models = copy.deepcopy(cpu_models)
    quantize_denoiser_(int8_models[0])
    float_models = [m.to(dev, torch.bfloat16) for m in cpu_models]
    int8_models = [m.to(dev, torch.bfloat16) for m in int8_models]
    del cpu_models
    configs = {
        "default": (float_models, {}, TIMED_CALLS),
        "int8": (int8_models, {}, TIMED_CALLS_INT8),
        "int8+fused": (int8_models, both, TIMED_CALLS_INT8)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = torch.randint(0, 256, (BATCH, 128, 128, 3), generator=gen,
                       device=dev, dtype=torch.uint8)
    post = torch.randn(BATCH, 16, 16, 4, generator=gen, device=dev)
    lat = torch.randn(BATCH, 16, 16, 4, generator=gen, device=dev)
    noise = dict(posterior_noise=post, latents_noise=lat)

    samplers, launches, shapes, eager_out = {}, {}, {}, {}
    for name, (models, options, _) in configs.items():
        sample = samplers[name] = make_sampler(models, dev, **options)
        with recording() as seen:      # the warm-up call
            sample(lr, **noise)
        torch.cuda.synchronize()
        shapes[name] = seen
        kernels.reset_launches()
        out = eager_out[name] = sample(lr, **noise)
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        log(f"{name}: launches in one sampler call: {launches[name]}")
        expected = expected_launches(*models, **options)
        for kernel, n in launches[name].items():
            want = expected[kernel]
            if n != sum(shapes[name][kernel].values()) \
                    or (want is not None and n != want) \
                    or (want is None and (n > 0) != (name != "default")):
                fail(f"{name}: {kernel} launched {n} times, the module tree "
                     f"gives {want}, the recorded calls "
                     f"{sum(shapes[name][kernel].values())}")
        if out.dtype != torch.uint8 \
                or tuple(out.shape) != (BATCH, 128, 128, 3) \
                or int(out.min()) == int(out.max()):
            fail(f"{name}: bad output {out.dtype} {tuple(out.shape)}")
    per_step = {k: n * STEPS for k, n in LN_FILM_SHAPES.items()}
    if dict(shapes["default"]["ln_film"]) != per_step \
            or dict(shapes["default"]["affine_warp"]) != WARP_SHAPES:
        fail(f"default path: recorded shapes {shapes['default']} differ from "
             "the tables")
    if dict(shapes["int8+fused"]["cnaf_small"]) != {
            (c, hw, "int8"): n * STEPS for (c, hw), n in FUSED_SHAPES.items()}:
        fail(f"int8 + fused path: fused blocks ran at "
             f"{shapes['int8+fused']['cnaf_small']}")
    log(f"[{time.perf_counter() - t_start:.0f} s] launch counts read")

    mm_shapes = shapes["int8"]["matmul_w8"] + shapes["int8+fused"]["matmul_w8"]
    log(f"matmul_w8 shapes (M, K, N) -> launches per call: int8 only "
        f"{dict(shapes['int8']['matmul_w8'])}, int8 + fused "
        f"{dict(shapes['int8+fused']['matmul_w8'])}")
    check_matmul_w8(dev, g, stats, mm_shapes)
    log(f"group_norm_silu shapes (C, H, W) -> launches per call: "
        f"{dict(shapes['int8+fused']['group_norm_silu'])}")
    check_group_norm_silu(dev, g, stats,
                          shapes["int8+fused"]["group_norm_silu"])
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] recorded shapes checked")

    # each configuration captured as CUDA graphs: the launches of the warm-up
    # and the capture (a replay launches nothing from Python) held to twice
    # the eager call's, one replay bit for bit against the eager call, then
    # eager calls and replays timed in turns; the captures dropped before
    # the next configuration
    per_call = {name: {"eager": collections.defaultdict(list),
                       "graphs": collections.defaultdict(list)}
                for name in configs}
    for name, (_, _, n) in configs.items():
        sample = samplers[name]
        captured, at_capture = warm_and_check(name, sample, lr, noise,
                                              eager_out[name])
        log(f"{name}: launches in the warm-up and the capture: {at_capture}")
        if any(at_capture[k] != 2 * launches[name][k] for k in at_capture):
            fail(f"{name}: the warm-up and the capture launched "
                 f"{at_capture}, not twice the eager call's "
                 f"{launches[name]}")
        torch.cuda.reset_peak_memory_stats()
        launched = 0    # launches from Python during the replays
        for _ in range(n):
            for stage, ms in timed_call(sample, lr, post, lat).items():
                per_call[name]["eager"][stage].append(ms)
            before = sum(kernels.LAUNCHES.values())
            for stage, ms in timed_replay(sample, captured, lr,
                                          noise).items():
                per_call[name]["graphs"][stage].append(ms)
            launched += sum(kernels.LAUNCHES.values()) - before
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if sample.replays != 1 + n or launched:
            fail(f"{name}: {sample.replays} replays (not {1 + n}), "
                 f"{launched} launches from Python in them: a call ran "
                 "eagerly")
        for mode, calls in per_call[name].items():
            report_calls(f"{name}, {mode}", calls, BATCH,
                         f"{STEPS} DDIM steps", smi)
        log(f"{name}: peak memory over the timed calls (models of every "
            f"configuration resident): {peak_gb:.2f} GB")
        del captured
        sample.clear_compiled()
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] three configurations timed "
        "eager and under graphs")

    # -- 11. other samplers under graphs, default configuration -------------
    graph_timings(float_models, dev, lr, noise, smi)
    log(f"[{time.perf_counter() - t_start:.0f} s] DPM++ and cached DDIM timed "
        "under graphs")

    # -- 12. the server at full width, before anything is profiled ----------
    server_launches = check_server(train_models, dev, smi, stats)
    log(f"[{time.perf_counter() - t_start:.0f} s] server checked and loaded")

    # -- 17 (a): world-1 NCCL, here, alone on the card ----------------------
    dp = check_data_parallel(dev, g, stats, smi)
    next(dp)
    log(f"[{time.perf_counter() - t_start:.0f} s] data parallelism (a) "
        "checked")

    # -- 13. the training CLIs, eager, before anything is profiled; the
    # -- convergence demo in a process of its own beside them, and phase
    # -- 17's two ranks from the refiner's runs on to 14's end ---------------
    import tempfile

    with tempfile.TemporaryDirectory() as keep, \
            tempfile.TemporaryDirectory() as demo_dir, \
            tempfile.TemporaryDirectory() as graphs_dir:
        demo = start_demo(demo_dir)
        graphs_cli = start_graphs_cli(graphs_dir)

        def before_refiner():
            # the captured CLI run done before phase 17's ranks hold the
            # card's memory
            join_graphs_cli(graphs_cli, graphs_dir, smi)
            next(dp)

        try:
            cli_stats = check_training_clis(
                dev, g, stats, smi, keep, before_refiner=before_refiner)
            torch.cuda.empty_cache()
            log(f"training CLIs [{smi}]: " + json.dumps(cli_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] training CLIs "
                "checked")

            # -- 14. the metrics and the distillation CLIs, on 13's stage
            # -- files, the ranks running -------------------------------------
            t14 = time.perf_counter()
            eval_stats, phase14_launches = check_eval_and_distillation(
                dev, g, stats, smi, keep)
            torch.cuda.empty_cache()
            log(f"metrics and distillation CLIs [{smi}]: "
                + json.dumps(eval_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] metrics and "
                f"distillation CLIs checked ({time.perf_counter() - t14:.0f} "
                "s)")

            # -- 17 (c), the one-process CLIs, the ranks' readings; then the
            # -- demo's: nothing runs beside the host timings from here on --
            dp_stats, phase17_launches = next(dp)
            log(f"data parallelism [{smi}]: " + json.dumps(dp_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] data parallelism "
                f"checked ({dp_stats.get('seconds', float('nan')):.0f} s "
                "here, the ranks "
                f"{dp_stats.get('ranks_s', float('nan')):.0f} s)")
            phase20_launches = join_demo(demo, demo_dir, dev, g, stats,
                                         smi)
            log(f"[{time.perf_counter() - t_start:.0f} s] convergence demo "
                "checked")
        finally:
            dp.close()      # the ranks stopped, where a phase raised
            for child in (demo, graphs_cli):
                if child.poll() is None:
                    child.kill()
                    child.wait()

        # -- 15. the PNG data path, on 13's stage files ----------------------
        with tempfile.TemporaryDirectory() as data:
            png_stats = check_png_data_path(dev, g, stats, smi, keep, data)
            torch.cuda.empty_cache()
            log(f"PNG data path [{smi}]: " + json.dumps(png_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] PNG data path "
                "checked")

            # -- 16. the JPEG codec slice, on 13's stage files and 15's tree
            codec_stats, phase16_launches = check_codec_path(
                dev, g, stats, smi, keep, png_stats["multipie_root"])
            torch.cuda.empty_cache()
            log(f"JPEG codec slice [{smi}]: " + json.dumps(codec_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] JPEG codec slice "
                "checked")

            # -- 18. the host image library, on 15's trees ----------------
            image_stats = check_host_image(smi, png_stats,
                                           png_stats["multipie_root"],
                                           png_stats["celeba_root"])
            log(f"host image library [{smi}]: " + json.dumps(image_stats))
            log(f"[{time.perf_counter() - t_start:.0f} s] host image "
                "library checked")

            # -- 19. the image formats the decoders gained, on 13's stage
            # -- files (12's server and 15's CelebA-HQ run took theirs) ---
            format_stats = check_image_formats(dev, smi, keep, data)
            torch.cuda.empty_cache()
    log(f"image formats [{smi}]: " + json.dumps(format_stats))
    log(f"[{time.perf_counter() - t_start:.0f} s] image formats checked")

    # -- 9. timed train steps, eager and captured, the last timing of the
    # -- run: each capture is profiled below without being made again -------
    train_stats, train_profiles = {}, []
    for kind, batch in (("refiner", REFINER_BATCH), ("cr", CR_BATCH)):
        launches[f"{kind} train"], shapes[f"{kind} train"], profile = \
            timed_train(kind, train_models, dev, batch, train_stats)
        train_profiles.append(profile)
    log(f"[{time.perf_counter() - t_start:.0f} s] train steps timed")

    # -- every timing is taken: now what runs under `torch.profiler`, so that
    # -- no timed launch follows a profiler trace in this process. The
    # -- card's own time in one train step of each kind and in one scan of
    # -- each configuration (what is left of them is the host's), then the
    # -- fused block's chain kernel by kernel --------------------------------
    for profile in train_profiles:
        profile()
    for name in configs:
        st = samplers[name].stages
        with torch.inference_mode():
            prep = st["prep"](lr, post, lat)
            torch.cuda.synchronize()
            busy, wall, top = device_busy_ms(
                lambda: (st["scan"](*prep), torch.cuda.synchronize()))
        scan = statistics.median(per_call[name]["eager"]["scan"])
        log(f"{name}: the card's kernels take "
            + ("not measured" if busy is None else f"{busy:.1f} ms")
            + f" of one profiled eager scan ({wall:.1f} ms on the host's "
            "clock)"
            + ("" if busy is None else
               f": idle {max(0.0, 1 - busy / scan):.3f} of the median eager "
               f"scan of {scan:.1f} ms")
            + f"; most device time: {top}")
        del prep
        # the same scan replayed from its graph (captured again: the timed
        # captures were dropped)
        captured = samplers[name].warm_compile(lr, **noise)
        g_busy, g_wall, _ = device_busy_ms(
            lambda: (captured.graphs["scan"].replay(),
                     torch.cuda.synchronize()))
        replay = statistics.median(per_call[name]["graphs"]["scan"])
        own = g_busy if g_busy is not None else busy
        ratio = None if own is None else replay / own
        log(f"{name}: the card's kernels take "
            + ("not measured" if g_busy is None else f"{g_busy:.1f} ms")
            + f" of one profiled scan replay ({g_wall:.1f} ms on the host's "
            f"clock); the median timed replay of the scan takes "
            f"{replay:.1f} ms: "
            + ("not measured" if ratio is None else
               f"{ratio:.3f} times the card's own time (limit "
               f"{GRAPH_SCAN_RATIO}) [{smi}]"))
        if ratio is None or ratio > GRAPH_SCAN_RATIO:
            fail(f"{name}: a replayed scan takes {replay:.1f} ms against "
                 f"{own} ms of the card's own time")
        del captured
        samplers[name].clear_compiled()
    del samplers, configs, float_models, int8_models
    report_chain_splits(stats, chains)
    del chains
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.0f} s] profiled")

    # -- one step of each other training stage -----------------------------
    log(f"ln_film_bwd maps (dtype, B, C, H, W) -> launches per refiner "
        f"step: {dict(shapes['refiner train']['ln_film_bwd'])}")
    log(f"affine_warp_bwd maps -> launches per CR step: "
        f"{dict(shapes['cr train']['affine_warp_bwd'])}")
    log("train steps [" + smi + "]: " + json.dumps(train_stats))
    other_steps_captured(train_models, dev, smi)
    log(f"[{time.perf_counter() - t_start:.0f} s] other train steps "
        "captured")

    entries = [
        stats.entry(k, path, launches, shapes)
        for k, path in (("ln_film", "default"), ("affine_warp", "default"),
                        ("matmul_w8", "int8+fused"),
                        ("group_norm_silu", "int8+fused"),
                        ("cnaf_small", "int8+fused"),
                        ("ln_film_bwd", "refiner train"),
                        ("affine_warp_bwd", "cr train"))]
    for entry in entries:
        if entry is not None and server_launches[entry["name"]]:
            # the server's cold start through its load: captured in the
            # warm-up, replayed while serving
            entry["server_launches"] = server_launches[entry["name"]]
        if entry is not None:
            # phase 14: a step's launches of each stage that launched it
            by_stage = {stage: n[entry["name"]]
                        for stage, n in phase14_launches.items()
                        if n.get(entry["name"])}
            if by_stage:
                entry["phase14_launches_per_step"] = by_stage
            # phase 16: the same for the blind training CLIs' --dataroot
            by_stage = {stage: n[entry["name"]]
                        for stage, n in phase16_launches.items()
                        if n.get(entry["name"])}
            if by_stage:
                entry["phase16_launches_per_step"] = by_stage
            # phase 20: each quality script's launches
            by_script = {name: n[entry["name"]]
                         for name, n in phase20_launches.items()
                         if n.get(entry["name"])}
            if by_script:
                entry["phase20_launches_by_script"] = by_script
            # phase 17: a step's launches on one of the two ranks
            by_stage = {stage: n[entry["name"]]
                        for stage, n in phase17_launches.items()
                        if n.get(entry["name"])}
            if by_stage:
                entry["phase17_launches_per_step_a_rank"] = by_stage
    log(f"[{time.perf_counter() - t_start:.0f} s] done")
    if FAILURES:
        print("chip_smoke failed:\n  " + "\n  ".join(FAILURES),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:     # one of phase 17's two ranks
        dp_child(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--demo-child"]:   # phase 13's convergence demo
        demo_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--graphs-cli-child"]:   # beside phase 13
        graphs_cli_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
