#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each followed by a ``{"phase": ..., "seconds": ...}`` line:

  0. device: exit non-zero when there is no CUDA device; print the card's
     name and power limit as ``nvidia-smi`` reports them;
  1. build: compile ``videoframeinterpolation_tpu_torch/kernels/csrc/*.cu``
     with one ``nvcc`` call and load it with ctypes; print each kernel's
     registers and spills as ``ptxas -v`` reports them;
  2. kernel: every kernel against its plain PyTorch version on the card:
     the deformable sampler at the three DAT level shapes of a 448x256
     request (B2 2), of a held-out evaluation batch (8 pairs of
     128x128, B2 16) and of ``validate_synthetic``'s batch (4 pairs of
     256x448, B2 8) for the shared-offset student (G 1, S 8/8/2), the
     non-shared checkpoint (G 4/8/8, S 8/16/32) and the teacher (G 1, S
     8/16/8), DCNDAT's (C 64, G 8/4/4, S 9) of a 448x256 request and of a
     validation batch (4 pairs of 256x448, B2 8), at the chunk of 8 tiles
     of 512x512 (B2 16) of the student and the non-shared checkpoint, at
     the student's full 720x1280 pair and its flow probe's 176x320 forward (B2 2), and at edge cases (far,
     integer, edge and negative positions, narrow groups, an odd group width, feat
     misaligned by a storage offset), in fp32 (max |diff| 0.0) and in bf16
     (0 ulps from the fp32 sampling of its bf16 inputs, rounded once); at
     each case the vector width and index width the wrapper picks, and
     every narrower width and the 64-bit index, so that every instance of
     the kernel runs; and two non-shared lv1 shapes whose output has more
     than 2^31 elements (64-bit indices: a 1080p request and the chunk of 8
     tiles), checked at their first and last (frame, sample) slices; the
     sampler's backward kernel against autograd through the plain version
     (``deformable_sample_backward_plain``) at the student's and the
     teacher's level shapes of a training batch (8 pairs of 128x128, B2
     16), DCNDAT's at its recipe (12 pairs of 256x256, B2 24) and at phase
     15's fp32 step (B2 4), and at edge cases (far outside, integer
     coordinates, every sample of every query on one pixel, odd group
     widths), in fp32 (each gradient within 1e-5 of its max abs) and bf16
     (at most 1 ulp from the fp32 gradient of the bf16 inputs, rounded
     once, or, where the fp32 sums cancel, within the fp32 limit), on its
     planned path (``grad_feat`` summed in shared memory) and on the global
     path forced, each at the widths the wrapper picks, every narrower
     width and both index widths, with ``grad_residual`` and ``grad_flow``
     equal bit for bit over two launches, after the card's figures that
     the backward's plan reads (``kernels/build.py``) are held to the
     card's device properties;
     the row and lane gathers at every shape of
     their probes and at an odd shape (equal, max |diff| 0); the row
     gather also at ``ROW_CASES`` (the largest probe shape in bf16, ragged
     rows, x and idx one element off alignment, K = 8M, a table of 60000
     rows) on 32- and 64-bit indices (``torch.equal``), and at an index of
     more than 2^31 elements on 64-bit indices; it fails if any instance
     never ran;
  3. serve: the shipped DAT_fast student at full width, in the bf16 of its
     YAML, answers four 448x256 requests and one 270x480 request through
     the serving entry point, with exactly 3 bf16 sampler launches each;
  4. cpu: one 448x256 request on the card against the same model on the
     CPU (plain path): in fp32 (a float32 config), max |diff| <= 1e-3 on the
     [0, 1] frame; in bf16, mean |diff| at most half the CPU's own gap
     between its bf16 and fp32 frames, the limit the CPU parity test with
     JAX sets;
  5. times: ms/frame at 448x256 in bf16 and in fp32 and, per DAT level
     of every shape of phase 2's level sets
     (``tools/perf/sampler_probe.py``), the sampler's time beside its
     bound, its plain version's time and F.grid_sample's time; the same
     for the stride arm's strided level 1 (``sampler_probe.main(2)`` and
     ``main_backward(2)``, on ``F.grid_sample``'s and
     ``grid_sampler_2d_backward``'s same coordinates), and the backward at
     DCNDAT's training levels (``main_backward(levels="dcndat")``);
  6. gather: the two gather probes
     (``videoframeinterpolation_tpu_torch.tools.perf.gather_probe`` and
     ``.lane_gather_probe``) at every shape: one checked launch each,
     times beside the bound, the plain version and ``torch.gather``;
  7. checkpoints: ``DAT`` and ``DAT_fast_teacher`` load their committed
     checkpoints and serve four 448x256 requests each in bf16 through
     ``load_model``/``interp_pair``, with exactly 3 bf16 sampler launches
     each; one request card against CPU as in phase 4; ms/frame in bf16;
  8. modes: the student in bf16 at 448x256: ``multi_t_apply`` at t = 1/4,
     1/2, 3/4 equal to the per-instant forward bit for bit
     (``torch.equal``), one encoder run (which launches no sampler) and 3
     bf16 launches per instant; the CLI's recursive and direct modes at
     factor 4 on a 3-frame ``.npy`` sequence write 9 frames each;
  9. eval: ``tools/eval_best.py``'s ``evaluate`` on the card in fp32 for
     the three checkpoints (32 scenes, 128x128, seed 42): each PSNR within
     0.005 dB and each SSIM within 5e-5 of the JAX package's CPU fp32 read
     (``JAX_CPU_FP32``), with 12 fp32 sampler launches per checkpoint; the
     TPU's record in ``eval_best.jsonl`` is printed beside it;
 10. train: (a) one distillation step of the shipped student's TrainState
     (step 14500) with the committed teacher, fp32, TF32 off, batch 2 at
     128x128, on the card against the same step on the CPU: the loss within
     1e-5 relative, the whole gradient within 1e-4 relative (L2), the
     updated parameters, ``mu`` and ``nu`` within 1e-6 absolute; each
     parameter's gradient error (of its max abs, floored at 1% of the
     largest) is printed beside the CPU's own change under rounding-level
     noise on its parameters (each times 1 + 2^-24 z); (b) the
     recipe through ``tools/head_to_head.py`` in bf16, resumed from that
     TrainState for 500 steps to step 15000 on the 768-scene pool (its
     pools rendered beforehand in worker processes, as phase 11's scenes;
     the later ``head_to_head`` pools of phases 15 and 16 are parts of
     them): the step-15000 ``train_loss`` within 5% of the record's and the held-out
     PSNR within 0.2 dB of it (``RECORD_15000``), with 3 student forward, 3
     teacher forward and 3 backward sampler launches per step (the backward
     all on its shared-memory path); ms per step
     and peak memory; (c) the ``.ckpt`` it wrote, read back by the port's
     reader, equals the final in-memory state leaf for leaf;
 11. evaluate: the evaluation entry point (``python -m
     videoframeinterpolation_tpu_torch.evaluate``) in fp32: ``--benchmark
     synthetic --ssim`` for the three checkpoints (64 scenes of 256x448,
     batches of 4, 3 fp32 launches per batch; the mean of the first
     ``SYNTHETIC_ITEMS``, the same batches as a loop over that many, within
     0.005 dB and 5e-5 SSIM of the JAX package's CPU fp32 read
     ``JAX_SYNTHETIC``, the 64-scene read printed beside it); then the
     shipped student on the Vimeo90K, UCF101 and SNU-FILM fixture trees
     (``FIXTURE_TREES``, PNG written by ``tools/fixtures.py``, SNU-FILM with
     an odd-sized triplet and each level listing its own triplets), each
     within 0.005 dB of the JAX loop's CPU fp32 read (``JAX_TREES``), 3
     launches per forward. The scenes, trees and the
     HD triplet are rendered beforehand in worker processes;
 12. serve_hd: a 720x1280 PNG pair (``HD_PAIR``) through ``interpolate
     --tile 512`` in bf16 (the plan ``(overlap, trim)`` equal to the JAX
     CLI's, ``JAX_HD_PLAN``; 3 launches for the flow probe and 3 for the
     one chunk of tiles; the tiled frame at least ``HD_SEAM_PSNR`` dB from
     the full-frame one), ms per pair tiled and full-frame in bf16, ``evaluate --benchmark
     snu --tile 512`` in fp32 on that triplet (the JAX plan, 24 launches for
     4 levels), the tiled fp32 frame on the card within 1e-3 max abs of the
     CPU's, and ``--mode direct --factor 4 --tile 512`` writing all 5
     frames (12 bf16 launches: the probe, 3 instants of one chunk);
 14. trainer (runs before 13): the production trainer through its entry
     point (``python -m videoframeinterpolation_tpu_torch.train``'s
     ``main``, in a child process: ``python3 chip_smoke.py --child``) on a
     seeded Vimeo90K-layout tree (``TRAINER_TREE``: 96 training triplets
     with their true flows and 8 test triplets at 256x448, rendered in
     worker processes) with ``configs/DAT_fast_distill.yaml`` and the
     committed teacher. Run A: the YAML's recipe at full width, batch 12,
     crop 256, bf16, 8 data workers, for 2 epochs of 8 steps, its cadences
     cut (``RUN_A``) and ``PROFILE_STEPS`` traced: per step 3 student
     forward, 3 teacher forward and 3 backward launches (all on the
     shared-memory path), 3 per validation batch and image summary, none
     in fp32; ``latest``, ``epoch_001``, ``epoch_002`` and ``best_vimeo90k``
     with JAX's metadata, each restoring bit for bit; ms per step (median
     and spread after the first 3 steps, the profiled ones left out), the
     ``data_time`` share, peak memory, the device's busy share and top
     operations of the traced steps. Runs B and C (``RUN_BC``: one epoch at
     one data worker): B is sent SIGTERM once its log shows step
     ``SIGTERM_AT_STEP``, exits 0 with ``latest`` saved, and ``--resume
     latest`` finishes it; its final parameters are held to C's within
     twice the gap between C and a second uninterrupted run C2 (the card
     sums ``grad_feat`` in a varying order; C and C2 run beside B).
     ``evaluate --exp_name`` on the card
     in fp32 within 0.005 dB and 5e-5 SSIM of the same on the CPU;
 15. families (runs after 14, on its tree): IFRNet, DAT-TPU, DCNDAT and
     DCNTrans v1 from ``configs/IFRNet.yaml``, ``configs/DAT_TPU.yaml``,
     ``configs/archive/DCNDAT.yaml`` and ``configs/archive/DCNTrans.yaml``
     at full width, and the quality study's
     dilated + group-offset DAT-TPU, each with a TrainState drawn with numpy
     from ``FAMILY_SEED`` (``seeded_family_state``, DCNTrans's kernels at
     ``FAMILY_KERNEL_GAIN``; no checkpoint of any family is committed).
     (a) Each written by the port's checkpoint writer and served through
     ``load_model`` in the YAML's bf16: four 448x256 requests through
     ``interp_pair``, ``FAMILY_LAUNCHES`` bf16 sampler launches each
     (DCNDAT 3, the others none); one request card against CPU as in
     phase 4; the fp32 frame on the held-out scene
     ``FAMILY_SCENE`` within 0.005 dB (PSNR against its true middle frame)
     and 1e-4 (its mean) of the JAX package's CPU fp32 read
     (``JAX_FAMILIES``); ms per frame in bf16 and fp32; device operations
     per request, busy share, and the deformable convolution's and the
     Swin decoders' shares (``tools/profile_serve.py``). (b) One fp32
     training step of each (its own recipe, TF32 off, batch 2 at 128x128)
     card against CPU to phase 10 (a)'s limits, with ``FAMILY_LAUNCHES``
     forward and backward launches; the production trainer's
     CLI with each YAML at its recipe (IFRNet batch 6, crop 224, with the
     forward flows written for its 48 sequences; DAT-TPU and DCNDAT batch
     12, crop 256; DCNTrans batch 8, crop 224, on the tree's first 64
     sequences; DCNDAT and DCNTrans on ``Vimeo90KwFlow``) for one epoch of
     8 steps,
     ``RUN_FAMILY``'s cadences and ``FAMILY_PROFILE_STEPS`` traced: ms per
     step, ``data_time`` share, peak memory, busy share,
     ``FAMILY_LAUNCHES`` launches per step, backward step, validation batch
     and image summary, ``latest``,
     ``epoch_001`` and ``best_vimeo90k`` restoring bit for bit;
     ``evaluate --exp_name`` on the card in fp32 within 0.005 dB and 5e-5
     SSIM of the same on the CPU. (c) ``tools/head_to_head.py`` on the
     variant for 20 steps on a 64-scene pool, its records under JAX's tag
     (``FAMILY_H2H_TAG``), ms per step;
 16. variants (runs after 15): the flagship's variants. (a) The sampler
     and its backward on the query grid of stride 2 (``STRIDED_CASES``: the
     stride arm's served lv1, feat (2, 128, 224, 72), G 1, S 16; its
     training lv1 at B2 16, 64x64; a non-shared shape, G 8 of 9 channels;
     flows that put taps past every border), held as phase 2 holds its
     cases, on both backward paths and every width (phase 5 times them).
     (b) The quality
     study's two arms (``VARIANTS``: ``configs/DAT_fast.yaml`` with samples
     8/8/16 and lv1 at stride 2, or samples 8/8/2 and movement widths
     72/72/36), each with a TrainState drawn with numpy from
     ``VARIANT_SEED``, written by the port's writer and served through
     ``load_model`` from a YAML in bf16: four 448x256 requests, 3 launches
     each (lv1 strided for the stride arm); one request card against CPU as
     in phase 4; the fp32 frame on ``FAMILY_SCENE`` against the JAX
     package's CPU read (``JAX_VARIANTS``) as in phase 15; ms per frame and
     ``tools/profile_serve.py``'s busy share. (c) ``evaluate --benchmark
     synthetic --ssim`` on the shipped student with and without
     ``--window_sampling`` on phase 11's scenes, equal bit for bit (both
     with cuDNN's deterministic algorithms) and within 0.005 dB of phase
     11's read; ``interpolate --window_sampling``, its frame equal to the
     unflagged run's; the committed ``DAT`` with
     ``dat_ref_offset_units``, card against CPU and against JAX's read.
     (d) One fp32 step of the stride arm card against CPU to phase 10
     (a)'s limits (the strided backward runs in it), and
     ``tools/head_to_head.py`` on each arm for 20 steps on a 64-scene pool
     (``VARIANT_H2H_ARMS``): JAX's tag, the record's n_params, ms per step,
     peak memory, 3 forward and 3 backward launches per step (the stride
     arm's lv1 strided both ways);
 13. shapes (runs last): every level shape at which phases 3-12, 14, 15 and
     16 launched the sampler (recorded at each launch, the children's too,
     with the query grid's stride) is listed; any that phase 2 or 16 did
     not hold is held here as phase 2 holds its cases (one needing 64-bit
     indices fails: it belongs in ``WIDE_CASES``); so is every level shape
     of a backward launch that ``BACKWARD_CASES`` or ``STRIDED_CASES`` does
     not list, on its planned path.

Each path's sampler launches (forward and backward) are counted from 0
just before it runs and read just after; the kernels line gives them per
path, and the backward's also per backward path; the strided launches of
phase 16 are the entries ``deformable_sample_strided`` and
``deformable_sample_backward_strided``. Phase 5 also times the
backward at the student's training levels on its planned path and on the
global path (``sampler_probe.main_backward``), and fails unless one call
on each path issues the device operations ``BWD_DEVICE_OPS`` gives it (2 on
the shared-memory path), as the profiler records them; a profiler that
records none fails too.

The serving entry point's ``load_model`` switches TF32 off (cuDNN
convolutions and matmuls), so an fp32 model computes in full fp32 on the
card, and phases 4 and 7 compare like with like; the evaluation switches
it off too, for the SSIM's ``conv3d``.

After the phases the script prints its whole time (``script_seconds``).
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()

SAMPLER_TOL = 0.0   # the sampler repeats the plain version's fp32 arithmetic step for step
E2E_TOL = 1e-3
BF16_GAP_SHARE = 0.5   # card vs CPU in bf16: at most this share of bf16's own gap
H, W = 256, 448
ODD_TABLE = ((999, 77, torch.bfloat16),)   # (M, N, dtype) beside the probes' shapes
# Row gather cases beyond the probes' shapes, name -> (M, N, K, dtype,
# storage offset of x and idx in elements): the largest probe shape in
# bf16, rows of 77 elements, x and idx at an offset of one element, eight
# index rows per table row, and a table of 60000 rows.
ROW_CASES = {
    "probe_28672_bf16": (28672, 128, 28677, torch.bfloat16, 0),
    "ragged_n77_fp32": (999, 77, 1004, torch.float32, 0),
    "ragged_n77_bf16": (999, 77, 1004, torch.bfloat16, 0),
    "offset1_fp32": (1000, 128, 1005, torch.float32, 1),
    "offset1_bf16": (1000, 128, 1005, torch.bfloat16, 1),
    "k8m_fp32": (1024, 128, 8192, torch.float32, 0),
    "k8m_bf16": (1024, 128, 8192, torch.bfloat16, 0),
    "m60000_fp32": (60000, 128, 60005, torch.float32, 0),
}
# Phase 9: the JAX package's CPU fp32 read of each committed checkpoint on
# the held-out pool (32 scenes, 128x128, seed 42), (PSNR dB, SSIM) as
# ``tools/quality/eval_best.py`` prints them, taken with
#   JAX_PLATFORMS=cpu python tools/quality/eval_best.py --ckpt <ckpt> [...] --out <file>
JAX_CPU_FP32 = {
    # --ckpt tools/quality/results/
    #     DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt --shared --samples 8,8,2
    "DAT_fast": (39.0314, 0.98187),
    # --ckpt tools/quality/results/DATwConstantnCv1_24k.best.ckpt
    "DAT": (37.9723, 0.97841),
    # --ckpt configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt --shared --samples 8,16,8
    "DAT_fast_teacher": (38.0076, 0.97963),
}
EVAL_PSNR_TOL = 0.005
EVAL_SSIM_TOL = 5e-5
# Phase 11 (evaluate): validate_synthetic's held-out scenes (256x448, seed 42,
# batches of 4) held to the JAX CPU read; the card also prints its read of
# the loop's 64. The fixture trees of the loops, benchmark -> (frame sizes,
# seed), written by tools/fixtures.py; and the HD pair of phase 12 (serve_hd),
# (size, seed), tiled at HD_TILE.
SYNTHETIC_ITEMS = 32
FIXTURE_TREES = {"vimeo90k": (((256, 448),) * 3, 11),
                 "ucf101": (((256, 256),) * 3, 12),
                 "snu": (((256, 448), (270, 480), (256, 448)), 13)}
HD_PAIR = ((720, 1280), 14)
HD_TILE = 512
# The JAX package's CPU fp32 reads of them, printed by
#   JAX_PLATFORMS=cpu python tests/jax_cpu_reads.py --part synthetic|trees|plan
# validate_synthetic over SYNTHETIC_ITEMS scenes, (PSNR dB, SSIM):
# (401.8 s, 710.0 s and 393.2 s on an 8-core host; most of it in ssim_3d):
JAX_SYNTHETIC = {"DAT_fast": (46.8831353187561, 0.9964991379529238),
                 "DAT": (46.38833129405975, 0.9961631074547768),
                 "DAT_fast_teacher": (46.16134071350098, 0.9960416611284018)}
# The student on each fixture tree (the loop's result, PSNR only):
JAX_TREES = {"vimeo90k": {"val/vimeo90k_psnr": 40.70245488484701},
             "ucf101": {"val/ucf101_psnr": 39.70137278238932},
             "snu": {"val/snu_test-easy_psnr": 46.52494430541992,
                     "val/snu_test-medium_psnr": 44.51464080810547,
                     "val/snu_test-hard_psnr": 52.0985107421875,
                     "val/snu_test-extreme_psnr": 47.71269861857096}}
# The plan (overlap, trim) for HD_PAIR at HD_TILE: the JAX evaluate.py's in
# fp32 (probe 28.14223289489746 px) and interpolate.py's in the YAML's bf16
# (probe 28.28125 px).
JAX_HD_PLAN = {"evaluate": (96, 48), "interpolate": (96, 48)}
# Phase 12: the bf16 tiled frame against the full-frame one. A seam, or a
# tile blended at the wrong place, reads far below this (51.63 dB on an
# NVIDIA H100 80GB HBM3).
HD_SEAM_PSNR = 40.0
# The same checkpoints as read on a TPU (tools/quality/results/eval_best.jsonl
# lines 8, 7 and 6): printed beside the card's read as history, not held.
TPU_EVAL_BEST = {"DAT_fast": (39.0322, 0.98176), "DAT": (37.9752, 0.97795),
                 "DAT_fast_teacher": (38.009, 0.97946)}
# Phase 2, the sampler's backward kernel: name -> (B2, H, W, C, G, S, residual
# scale, flow magnitude). The levels of a training batch (8 pairs of
# 128x128, B2 16) of the student (S 8/8/2) and the teacher (S 8/16/8; its
# lv3 is the student's); DCNDAT's (C 64, G 8/4/4, S 9) at its recipe (12
# pairs of 256x256, B2 24) and at phase 15's fp32 step (2 pairs of 128x128,
# B2 4); then edge cases: every tap outside, integer
# coordinates, groups of 9 and 7 channels, and every sample of every query
# on one pixel (all atomics of the call into four taps).
BACKWARD_CASES = {
    "train_student_lv3": (16, 16, 16, 72, 1, 8, 2.0, 4.0),
    "train_student_lv2": (16, 32, 32, 72, 1, 8, 4.0, 4.0),
    "train_student_lv1": (16, 64, 64, 72, 1, 2, 8.0, 4.0),
    "train_teacher_lv2": (16, 32, 32, 72, 1, 16, 4.0, 4.0),
    "train_teacher_lv1": (16, 64, 64, 72, 1, 8, 8.0, 4.0),
    "train_dcndat_lv3": (24, 32, 32, 64, 8, 9, 2.0, 4.0),
    "train_dcndat_lv2": (24, 64, 64, 64, 4, 9, 2.0, 4.0),
    "train_dcndat_lv1": (24, 128, 128, 64, 4, 9, 2.0, 4.0),
    "step_dcndat_lv3": (4, 16, 16, 64, 8, 9, 2.0, 4.0),
    "step_dcndat_lv2": (4, 32, 32, 64, 4, 9, 2.0, 4.0),
    "step_dcndat_lv1": (4, 64, 64, 64, 4, 9, 2.0, 4.0),
    "far_outside": (2, 9, 13, 40, 8, 3, 30.0, 1e4),
    "integer": (2, 16, 16, 72, 1, 8, 2.0, 3.0),
    "cg9": (1, 9, 13, 72, 8, 3, 30.0, 4.0),
    "odd_cg7": (2, 11, 17, 21, 3, 5, 3.0, 4.0),
    "one_pixel": (2, 16, 16, 16, 1, 8, 0.0, 0.0),
}
BWD_FP32_TOL = 1e-5   # of each gradient's max abs: fp32 sums in other orders, atomics
# bf16: at most 1 ulp from the fp32 gradient of the bf16 inputs, rounded once;
# where the fp32 sums cancel (a result far below its terms), the two fp32
# sums differ by more than a bf16 ulp of the result, and the element is held
# to BWD_FP32_TOL of the gradient's max abs instead.
BWD_BF16_ULPS = 1.0
# Device operations one backward call issues, by path and dtype: the feature
# and the coordinate kernels; on the global path also its fp32 buffer's
# zero-fill and, in bf16, the buffer's cast. (The first design issued 5: two
# zero-fills, its kernel and two casts.)
BWD_DEVICE_OPS = {"smem": {"bfloat16": 2, "float32": 2},
                  "global": {"bfloat16": 4, "float32": 3}}
# Phase 10: the shipped student's curve at step 15000
# (tools/quality/results/DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.jsonl),
# the mean loss of steps 14501-15000 and the held-out PSNR.
RECORD_15000 = {"train_loss": 0.01715, "val_psnr": 39.0027}
TRAIN_LOSS_REL_TOL = 0.05
TRAIN_PSNR_TOL = 0.2
STEP_LOSS_REL_TOL = 1e-5   # (a): card vs CPU, fp32
# The whole gradient (every parameter's, concatenated), relative L2. Per
# parameter the gradient is held to no fixed limit: moving the CPU's own
# parameters by rounding-level noise moves single parameters' gradients by
# up to ~1e-3 of their max abs (bilinear taps and PReLU kinks switch), so
# that spread is measured in the run and printed beside the card's.
STEP_GRAD_TOL = 1e-4
STEP_STATE_TOL = 1e-6      # parameters, mu, nu, absolute
# Phase 14 (trainer): a seeded tree in Vimeo90K's layout (training triplets
# of the generator's training split with their true flows at t = 0.5, test
# triplets of its held-out split), written by tools/fixtures.py.
TRAINER_TREE = {"train": 96, "test": 8, "hw": (256, 448), "seed": 31}
TRAINER_RECIPE = "configs/DAT_fast_distill.yaml"
TRAINER_TEACHER = "configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt"
# Run A: the YAML's recipe (full width, batch 12, crop 256, bf16, 8 data
# workers, the teacher in the loop) for 2 epochs of 8 steps, its cadences
# cut so that every save, validation and image branch fires; profiled over
# PROFILE_STEPS.
RUN_A = ["num_epochs=2", "save_latest_freq=5", "save_every_freq_epoch=1", "valid_freq_epoch=1",
         "img_summary_freq=8", "metric_summary_freq=1"]
PROFILE_STEPS = (5, 7)
# Runs B and C: one epoch at one data worker (a reproducible data stream),
# no validation; B is sent SIGTERM once its log shows step SIGTERM_AT_STEP,
# then resumed from 'latest'.
RUN_BC = ["num_epochs=1", "num_workers=1", "metric_summary_freq=1", "save_latest_freq=1000",
          "save_every_freq_epoch=1", "val_datasets=[]"]
SIGTERM_AT_STEP = 5
DATA_TIMED_ITEMS = 48   # training items timed on the host, per data path
RENDER_WORKERS = min(8, os.cpu_count() or 1)   # render_pool's worker processes
# Phase 15 (families): IFRNet, DAT-TPU, DCNDAT and DCNTrans v1 from their
# YAMLs at full width, and the quality study's dilated + group-offset DAT-TPU
# (head_to_head's OFFSET_SETS and OFFSET_GROUPS). No checkpoint of any family
# is committed: each TrainState is drawn with numpy from FAMILY_SEED
# (seeded_family_state) at step FAMILY_STEP, the same on every machine.
FAMILIES = {"IFRNet": "configs/IFRNet.yaml", "DAT_TPU": "configs/DAT_TPU.yaml",
            "DAT_TPU_dilated_goff": "configs/DAT_TPU.yaml",
            "DCNDAT": "configs/archive/DCNDAT.yaml",
            "DCNTrans": "configs/archive/DCNTrans.yaml"}
# Sampler launches per forward (and, in training, backward launches per
# step) of each family: DCNDAT's three levels each sample both frames in one
# launch; the others launch none.
FAMILY_LAUNCHES = {"IFRNet": 0, "DAT_TPU": 0, "DAT_TPU_dilated_goff": 0, "DCNDAT": 3,
                   "DCNTrans": 0}
FAMILY_SEED = 15
FAMILY_STEP = 1000
# The factor on each family's U(+-1/sqrt(fan_in)) kernels (default 1). At
# the full bound DCNTrans's bf16 frame at 448x256 is chaotic: it moves by
# 0.80 of its bf16-vs-fp32 gap when its input moves by 1e-6, so that no
# device can hold it to half of that gap; at half the bound it moves by
# 0.06 (the port on the CPU).
FAMILY_KERNEL_GAIN = {"DCNTrans": 0.5}
# The held-out SyntheticMotion scene each family serves: (size, seed), index 0.
FAMILY_SCENE = ((256, 448), 16)
# The JAX package's CPU fp32 read of each family's frame on FAMILY_SCENE at
# t = 0.5 with the same parameters, (PSNR dB against the true middle frame,
# the frame's mean), printed by
#   JAX_PLATFORMS=cpu python tests/jax_cpu_reads.py --part families
JAX_FAMILIES = {"IFRNet": (34.58601270023546, 0.48564809877938214),
                "DAT_TPU": (19.298734448338216, 0.5239750224028241),
                "DAT_TPU_dilated_goff": (19.246799060622894, 0.5084678643933807),
                "DCNDAT": (19.49973414223694, 0.4963412535387414),
                "DCNTrans": (19.837724593649583, 0.49248217925291793)}
FAMILY_MEAN_TOL = 1e-4
# The production trainer on phase 14's tree at each YAML's recipe (IFRNet
# batch 6, crop 224, with the forward flows written for its sequences;
# DAT-TPU and DCNDAT batch 12, crop 256; DCNTrans batch 8, crop 224), for
# one epoch of 8 steps: the training sequences each reads (a family that
# reads fewer than the tree's 96 gets a root beside it that lists its
# first ones), its cadences cut, the traced steps.
# configs/archive/DCNDAT.yaml and DCNTrans.yaml name data_name Vimeo90K,
# whose batches carry no flows for their flow distillation: their runs read
# them (Vimeo90KwFlow, with the YAML's flow_dir and distill_bwd).
FAMILY_TRAIN_SEQUENCES = {"IFRNet": 48, "DAT_TPU": 96, "DCNDAT": 96, "DCNTrans": 64}
FAMILY_TRAIN_SETS = {"DCNDAT": ["data_name=Vimeo90KwFlow"],
                     "DCNTrans": ["data_name=Vimeo90KwFlow"]}
RUN_FAMILY = ["num_epochs=1", "save_latest_freq=4", "save_every_freq_epoch=1",
              "valid_freq_epoch=1", "img_summary_freq=8", "metric_summary_freq=1"]
FAMILY_PROFILE_STEPS = (5, 6)
# The quality study's trainer on the variant: 20 steps on a 64-scene pool.
FAMILY_H2H = ["--model", "DATwConstantnCTPU", "--dilated", "--goff", "--steps", "20",
              "--pool", "64", "--chunk", "10", "--eval_every", "20", "--warmup", "5"]
FAMILY_H2H_TAG = "DATwConstantnCTPU_dilated_goff_0k"
# Phase 16 (variants): the quality study's two arms of the flagship at full
# width, configs/DAT_fast.yaml (nf 72, 5 and 10 residual blocks, shared
# offsets) with each arm's fields. No checkpoint of either is committed: each
# TrainState is drawn with numpy from VARIANT_SEED (seeded_state).
VARIANTS = {"stride_arm": {"dat_samples": [8, 8, 16], "dat_attn_stride": [1, 1, 2]},
            "movement_arm": {"dat_samples": [8, 8, 2], "dat_movement_nf": [72, 72, 36]}}
VARIANT_SEED = 16
# The JAX package's CPU fp32 read of each arm's frame, and of the committed DAT
# checkpoint served with dat_ref_offset_units, on FAMILY_SCENE at t = 0.5,
# (PSNR dB against the true middle frame, the frame's mean), printed by
#   JAX_PLATFORMS=cpu python tests/jax_cpu_reads.py --part variants
JAX_VARIANTS = {"stride_arm": (19.18512757950843, 0.5130276850458835),
                "movement_arm": (19.262677338541817, 0.4796249087573545),
                "DAT_ref_offset_units": (43.831387732732935, 0.4893518048669908)}
# The sampler on the stride arm's query grid of stride 2: (B2, H, W, C, G, S,
# residual scale, flow magnitude), H x W the feature grid: the served lv1 of a
# 448x256 request, the lv1 of a training batch (8 pairs of 128x128), a
# non-shared shape (G 8, 9 channels each) and flows that put taps past every
# border.
STRIDED_CASES = {"served_stride_arm_lv1": (2, 128, 224, 72, 1, 16, 8.0, 4.0),
                 "train_stride_arm_lv1": (16, 64, 64, 72, 1, 16, 8.0, 4.0),
                 "non_shared_cg9": (2, 16, 24, 72, 8, 4, 8.0, 4.0),
                 "past_borders": (2, 10, 14, 40, 8, 3, 30.0, 40.0)}
# The quality study's trainer on each arm: 20 steps on a 64-scene pool, its
# flags, JAX's tag and the record's n_params.
VARIANT_H2H = ["--model", "DATwConstantnCv1", "--steps", "20", "--pool", "64", "--chunk", "10",
               "--eval_every", "20", "--warmup", "5"]
VARIANT_H2H_ARMS = {
    "stride_arm": (["--shared", "--samples", "8,8,16", "--attn_stride", "2"],
                   "DATwConstantnCv1_shared_s8-8-16_stride2_0k", 4_712_375),
    "movement_arm": (["--shared", "--samples", "8,8,2", "--movement_nf", "72,72,36"],
                     "DATwConstantnCv1_shared_s8-8-2_mv72-72-36_0k", 4_275_595)}
# An index of K x N >= 2^31 elements (64-bit indices): 2^24 + 1 rows of a
# 1024-row bf16 table, checked at its first and last rows.
ROW_WIDE = (1024, 128, 2 ** 24 + 1, torch.bfloat16)
# Level shapes whose output needs 64-bit indices, checked at their first
# and last (frame, sample) slices: the non-shared lv1 of a 1920x1080 request
# (padded to 1088x1920) and of a chunk of 8 tiles of 512x512 (B2 16), each
# with about 2.4e9 output elements. (B2, H, W, C, G, S, offset scale).
WIDE_CASES = {"1080p_non_shared_lv1": (2, 544, 960, 72, 8, 32, 8.0),
              "tile8_512_non_shared_lv1": (16, 256, 256, 72, 8, 32, 8.0)}


def emit(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def reset_sampler_counts() -> None:
    """Set every launch count of the sampler's wrapper to 0."""
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample as ds

    ds.launches = ds.bf16_launches = ds.strided_launches = 0
    ds.backward_launches = ds.strided_backward_launches = 0
    ds.backward_path_launches.update(dict.fromkeys(ds.backward_path_launches, 0))


def sampler_counts() -> dict:
    """The sampler's launch counts since :func:`reset_sampler_counts`."""
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample as ds

    return {"forward": ds.launches, "bf16_forward": ds.bf16_launches,
            "strided_forward": ds.strided_launches, "backward": ds.backward_launches,
            "strided_backward": ds.strided_backward_launches,
            "backward_by_path": dict(ds.backward_path_launches)}


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        emit(f"== phase {self.name} (elapsed {time.perf_counter() - _T0:.1f} s)")
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t, 3)})
        return False


def sampler_cases(gen, level_inputs, level_sets, channels):
    """name -> (feat, flow, residual, storage offset of feat in elements), fp32
    on the card: the level shapes (``channels[kind]`` channels, else 72),
    then inputs whose sample positions or widths hit the sampler's edge
    conditions."""
    cases = {f"{kind}_{name}": (*level_inputs(gen, B2, h, w, channels.get(kind, 72), G, S,
                                              sc), 0)
             for kind, levels in level_sets.items() for name, B2, h, w, G, S, sc in levels}
    B2, h, w, C, S = 2, 32, 56, 72, 8
    feat, flow, res = level_inputs(gen, B2, h, w, C, 1, S, 2.0)
    gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([gx, gy], -1)[None]
    frac = torch.rand((B2, h, w, 1, S, 2), generator=gen, device="cuda")
    far = torch.randn((B2, h, w, 2), generator=gen, device="cuda") * 1e4
    integer = torch.round(torch.randn((B2, h, w, 2), generator=gen, device="cuda") * 3)
    last = torch.tensor([w - 1.0, h - 1.0], device="cuda") - base
    neg = -base - 1.5
    cases.update({
        "far_outside": (feat, far.contiguous(), res, 0),
        "on_integers": (feat, integer.contiguous(), torch.round(res), 0),
        "last_row_col": (feat, last.expand(B2, h, w, 2).contiguous(),
                         torch.where(frac < 0.25, 0.0, frac - 0.5), 0),
        "negative": (feat, neg.expand(B2, h, w, 2).contiguous(), frac * 2.0, 0),
        "groups4_cg18": (*level_inputs(gen, B2, h, w, C, 4, S, 2.0), 0),
        "groups8_cg9": (*level_inputs(gen, 1, 9, 13, 72, 8, 3, 30.0), 0),
        "odd_c40_g8": (*level_inputs(gen, 1, 9, 13, 40, 8, 3, 30.0), 0),
        "c40_g1": (*level_inputs(gen, 1, 9, 13, 40, 1, 3, 30.0), 0),
        "odd_cg7": (*level_inputs(gen, 2, 11, 17, 21, 3, 5, 3.0), 0),
    })
    for offset in (1, 2, 4):
        cases[f"misaligned_by_{offset}"] = (feat, flow, res, offset)
    return cases


def path_level_sets(sampler_probe) -> dict:
    """The level shapes of this slice's paths beside the probe's: the eval
    batch of 4 at 256x448 (B2 8) of each configuration, in which
    ``validate_synthetic`` runs, and a chunk of 8 tiles of 512x512 (B2 16)
    of the student and of the non-shared configuration, as ``--tile 512``
    sends them (the non-shared lv1 of that chunk is in ``WIDE_CASES``); the
    student's full 720x1280 pair (B2 2), which phase 12 serves whole as the
    tiled frame's reference, and its flow probe, the 1/4-scale forward at
    176x320 (B2 2) that every tiled request of phase 12 runs."""
    levels = sampler_probe._levels
    shared = sampler_probe.CONFIG_LEVELS["shared"]
    sets = {f"eval4_{kind}": levels(8, 256, 448, gs)
            for kind, gs in sampler_probe.CONFIG_LEVELS.items()}
    sets["tile8_shared"] = levels(16, 512, 512, shared)
    sets["tile8_non_shared"] = levels(16, 512, 512,
                                      sampler_probe.CONFIG_LEVELS["non_shared"])[:2]
    sets["hd_full_shared"] = levels(2, 720, 1280, shared)
    sets["hd_probe_shared"] = levels(2, 176, 320, shared)
    return sets


def level_shape(feat: torch.Tensor, residual: torch.Tensor) -> tuple:
    """``(B2, H, W, C, G, S, stride)`` of one sampler call: the feature
    grid, the groups and samples, and the query grid's stride over it."""
    return (*feat.shape, residual.shape[3], residual.shape[4], feat.shape[1] // residual.shape[1])


def check_sampler_case(name: str, feat32, flow32, res32, offset: int, reached: set,
                       stride: int = 1) -> float:
    """The sampler at one case (on a query grid of ``stride``), in fp32 and
    bf16, against the fp32 sampling of its inputs rounded once: through the
    wrapper (the vector and index width it picks), then at every narrower
    vector width and both index widths (``reached`` collects each instance
    run). Returns the wrapper's max abs error."""
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _index_bits, _launch, _vector_bytes, deformable_sample)

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        feat = at_offset(feat32.to(dtype), offset)
        flow, res = flow32.to(dtype), res32.to(dtype)
        B2, h, w, C = feat.shape
        G, S = res.shape[3], res.shape[4]
        ref = sampler_ref(feat, flow, res, stride)
        out = deformable_sample(feat, flow, res, G, stride=stride)
        torch.cuda.synchronize()
        plan = (_vector_bytes(C, G, feat.element_size(), feat.data_ptr(), out.data_ptr()),
                _index_bits(B2, h, w, C, G, S, stride))
        # Every narrower width and the 64-bit index on the same inputs.
        checked = {plan: out}
        width = plan[0]
        while width >= feat.element_size():
            for bits in (32, 64):
                if (width, bits) not in checked:
                    checked[width, bits] = _launch(feat, flow, res, G, width, bits,
                                                   stride=stride)
            width //= 2
        torch.cuda.synchronize()
        for (width, bits), got in checked.items():
            err = (got.float() - ref).abs().max().item()
            reached.add((str(dtype), width, bits))
            if not err <= SAMPLER_TOL:
                raise AssertionError(f"sampler vs reference, case {name} {dtype} "
                                     f"V={width} {bits}-bit: {err} > {SAMPLER_TOL}")
        err = (out.float() - ref).abs().max().item()
        worst = max(worst, err)
        emit({"case": name, "dtype": str(dtype), "shape": list(res.shape), "stride": stride,
              "feat_offset_bytes": feat.data_ptr() % 16, "vector_bytes": plan[0],
              "index_bits": plan[1], "instances": sorted(checked), "max_abs_err": err,
              **({"max_err_in_ulps": bf16_ulps(out.float(), ref)}
                 if dtype == torch.bfloat16 else {})})
        del feat, flow, res, ref, out, checked
    return worst


def sampler_ref(feat, flow, res, stride: int = 1):
    """The sampler's reference: in fp32 it must equal its plain version; in
    bf16 it takes res + flow in fp32 (as the plain version does), samples
    in fp32 and rounds once, so it must equal the fp32 sampling of the same
    bf16 inputs, rounded once (0 bf16 ulps). For fp32 inputs this
    reference is the plain version itself."""
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _grouped_deformable_sample)

    ref = _grouped_deformable_sample(
        feat.float(), res.float() + flow.float()[:, :, :, None, None, :], res.shape[3], stride)
    return ref.to(feat.dtype).float()


def record_level_shapes(window_sample) -> tuple[set, set]:
    """Collect the ``level_shape`` of every forward and every backward
    launch of the sampler from now on (by wrapping the module's launches,
    which the wrapper and the autograd function call); returns the two sets
    it fills."""
    forward, backward = set(), set()
    launch, launch_backward = window_sample._launch, window_sample._launch_backward

    def recording(feat, flow, residual, n_groups, *args, **kwargs):
        forward.add(level_shape(feat, residual))
        return launch(feat, flow, residual, n_groups, *args, **kwargs)

    def recording_backward(feat, flow, residual, grad_out, n_groups, *args, **kwargs):
        backward.add(level_shape(feat, residual))
        return launch_backward(feat, flow, residual, grad_out, n_groups, *args, **kwargs)

    window_sample._launch = recording
    window_sample._launch_backward = recording_backward
    return forward, backward


def at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` elements into a
    larger buffer, so that its data pointer is aligned to that offset only."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def main() -> int:
    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                  "nothing was run", file=sys.stderr, flush=True)
            return 1
        kind = torch.cuda.get_device_name(0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        emit(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
        emit(card)

    sys.path.insert(0, str(ROOT))
    from videoframeinterpolation_tpu_torch.config import DAT_fast, PRESETS
    from videoframeinterpolation_tpu_torch.interpolate import SHIPPED_STUDENT, load_model
    from videoframeinterpolation_tpu_torch.kernels import (
        build, lane_gather, lane_gather_plain, row_gather, row_gather_plain)
    from videoframeinterpolation_tpu_torch.kernels import window_sample
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _index_bits, deformable_sample)
    from videoframeinterpolation_tpu_torch.tools.perf import (
        gather_probe, lane_gather_probe, sampler_probe, timing)

    with Phase("build"):
        nvcc = build.find_nvcc()
        emit(f"nvcc {nvcc}: {build.nvcc_release(nvcc)}")
        t = time.perf_counter()
        build.load_library()
        emit({"build_seconds": round(time.perf_counter() - t, 3), "nvcc": nvcc,
              "sources": [str(p.relative_to(ROOT)) for p in build.sources()]})
        for row in build.ptxas_report():
            emit({"ptxas": row})

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {}
    with Phase("kernel"):
        reached = set()
        cases = sampler_cases(gen, sampler_probe.level_inputs,
                              {**sampler_probe.LEVEL_SETS, **path_level_sets(sampler_probe)},
                              sampler_probe.LEVEL_CHANNELS)
        for name, (feat32, flow32, res32, offset) in cases.items():
            err = check_sampler_case(name, feat32, flow32, res32, offset, reached)
            max_err["deformable_sample"] = max(max_err.get("deformable_sample", 0.0), err)
        checked_shapes = {level_shape(feat, res) for feat, _, res, _ in cases.values()}
        del cases
        # 64-bit indices, as the wrapper picks them: the first and last
        # (frame, sample) slices against the reference on those slices.
        for case, (B2, h, w, C, G, S, sc) in WIDE_CASES.items():
            wide = sampler_probe.level_inputs(gen, B2, h, w, C, G, S, sc)
            for dtype in (torch.bfloat16, torch.float32):
                feat, flow, res = (x.to(dtype) for x in wide)
                out = deformable_sample(feat, flow, res, G)
                torch.cuda.synchronize()
                bits = _index_bits(B2, h, w, C, G, S)
                finite = bool(torch.isfinite(out).all())
                errs = []
                for b, s_ in ((0, 0), (B2 - 1, S - 1)):
                    ref = sampler_ref(feat[b:b + 1], flow[b:b + 1],
                                      res[b:b + 1, :, :, :, s_:s_ + 1])
                    errs.append((out[b:b + 1, s_:s_ + 1].float() - ref).abs().max().item())
                reached.add((str(dtype), "wide", bits))
                emit({"case": f"wide_index_{case}", "dtype": str(dtype),
                      "shape": list(res.shape), "out_elements": out.numel(), "index_bits": bits,
                      "finite": finite, "max_abs_err_first_last_slices": errs})
                if bits != 64 or not finite or max(errs) > SAMPLER_TOL:
                    raise AssertionError(f"wide sampler case {case} {dtype}: {bits}-bit, "
                                         f"finite {finite}, errors {errs}")
                del feat, flow, res, out
            del wide
            torch.cuda.empty_cache()
            checked_shapes.add((B2, h, w, C, G, S, 1))
        need = ({("torch.float32", v, b) for v in (16, 8, 4) for b in (32, 64)}
                | {("torch.bfloat16", v, b) for v in (16, 8, 4, 2) for b in (32, 64)}
                | {("torch.float32", "wide", 64), ("torch.bfloat16", "wide", 64)})
        if need - reached:
            raise AssertionError(f"sampler instances never run: {sorted(need - reached, key=str)}")
        emit({"sampler_paths_checked": len(need), "max_abs_err": max_err["deformable_sample"]})
        torch.cuda.empty_cache()
        for kernel, plain, axis, shapes in (
                (row_gather, row_gather_plain, 0, gather_probe.SHAPES + ODD_TABLE),
                (lane_gather, lane_gather_plain, 1, lane_gather_probe.SHAPES + ODD_TABLE)):
            for M, N, dtype in shapes:
                x = torch.randn((M, N), generator=gen, device="cuda", dtype=dtype)
                # More index rows (row gather) or fewer columns (lane gather)
                # than the table has, to hold the kernels to take_along_axis.
                idx_shape = (M + 5, N) if axis == 0 else (M, N - 3)
                idx = torch.randint(0, (M, N)[axis], idx_shape, generator=gen, device="cuda",
                                    dtype=torch.int32)
                out = kernel(x, idx)
                torch.cuda.synchronize()
                err = (out.float() - plain(x, idx).float()).abs().max().item()
                emit({"case": kernel.__name__, "table": [M, N], "index": list(idx.shape),
                      "dtype": str(dtype), "max_abs_err": err})
                if not (err == 0.0 and torch.equal(out, plain(x, idx))):
                    raise AssertionError(f"{kernel.__name__} vs plain at {M}x{N} {dtype}: {err}")
                max_err[kernel.__name__] = max(max_err.get(kernel.__name__, 0.0), err)
        del x, idx, out
        check_row_gather(gen, gather_probe.SHAPES)
        bwd_err = check_backward(gen)
    # From here on, every level shape a path launches the sampler at is
    # recorded; phase 13 holds those that phase 2 did not.
    launched_shapes, launched_backward = record_level_shapes(window_sample)

    rng = np.random.default_rng(0)
    tex = smooth_texture(rng, 320, 512)
    shift = (4, 8)   # (dy, dx) between frame 0 and frame 1
    path_launches = {}
    with Phase("serve"):
        model = load_model(DAT_fast, SHIPPED_STUDENT, device="cuda")
        if model.dtype != torch.bfloat16 or DAT_fast.compute_dtype != "bfloat16":
            raise AssertionError(f"DAT_fast served in {model.dtype}, its YAML says bfloat16")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("load_model left TF32 on: an fp32 model would not compute fp32")
        n_params = sum(p.numel() for p in model.parameters())
        emit({"checkpoint": str(SHIPPED_STUDENT.relative_to(ROOT)), "nf": DAT_fast.nf,
              "params": n_params, "dtype": str(model.dtype)})
        requests = [((H, W), 0.5), ((H, W), 0.25), ((H, W), 0.5), ((H, W), 0.25),
                    ((270, 480), 0.5)]
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        serve_requests(model, requests, tex, shift, "DAT_fast")
        path_launches["serve"] = deformable_sample.launches
        emit({"main_path_launches": path_launches["serve"],
              "bf16_launches": deformable_sample.bf16_launches, "requests": len(requests)})

    fp32_cfg = dataclasses.replace(DAT_fast, compute_dtype="float32")
    f0, f1, _ = frames(tex, H, W, shift, 0.5)
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None] for f in (f0, f1))
    t5 = torch.full((1, 1, 1, 1), 0.5)
    with Phase("cpu"):
        model32 = card_vs_cpu(DAT_fast, SHIPPED_STUDENT, model, x0, x1, t5)

    # The CPU threads of phase 4 would compete with the thread that issues
    # the card's work.
    torch.set_num_threads(1)
    with Phase("times"):
        xs = (x0.cuda(), x1.cuda(), t5.cuda())
        with torch.inference_mode():
            for name, m in (("bf16", model), ("fp32", model32)):
                frame_ms = timing.loop_ms(lambda: m(*xs), 20, warmup=5) / 20
                emit({f"ms_per_frame_448x256_{name}": frame_ms, "card": card})
        del model32
        per_level = sampler_probe.main()
        per_level_bwd = sampler_probe.main_backward()
        # DCNDAT's training levels (C 64, G 8/4/4, S 9; B2 24).
        per_level_bwd_dcndat = sampler_probe.main_backward(levels="dcndat")
        # The stride arm's strided level 1 (phase 16 holds its kernels).
        strided = {"forward": sampler_probe.main(stride=2),
                   "backward": sampler_probe.main_backward(stride=2)}
        served, trained = (strided["forward"]["stride_arm"]["bfloat16"]["lv1"],
                           strided["backward"]["bfloat16"]["lv1"])
        emit({"strided_sampler_speed": {
            "served_lv1_bf16": {k: served[k] for k in ("ms", "bound_ms", "library_ms",
                                                       "share_of_bound", "library_over_kernel")},
            "train_lv1_bf16_backward": {k: trained[k] for k in (
                "ms", "global_ms", "bound_ms", "library_ms", "share_of_bound")},
            "card": card}})
        # The main path's levels: the shared-offset student in bf16.
        shared = list(per_level["shared"]["bfloat16"].values())
        emit({"sampler_speed": {
            "shared_bf16_kernel_over_library": (sum(r["ms"] for r in shared)
                                                / sum(r["library_ms"] for r in shared)),
            "shared_bf16_share_of_bound": (sum(r["bound_ms"] for r in shared)
                                           / sum(r["ms"] for r in shared)),
            "faster_than_library": {f"{kind}_{dtype}_{name}": r["ms"] < r["library_ms"]
                                    for kind, by_dtype in per_level.items()
                                    for dtype, rows in by_dtype.items()
                                    for name, r in rows.items()},
            "card": card}})
        dcndat_fwd = per_level["dcndat"]["bfloat16"]
        dcndat_bwd = per_level_bwd_dcndat["bfloat16"]
        emit({"dcndat_sampler_speed": {
            "served_bf16": {lv: {k: r[k] for k in ("ms", "bound_ms", "library_ms",
                                                   "share_of_bound", "library_over_kernel")}
                            for lv, r in dcndat_fwd.items()},
            "train_bf16_backward": {lv: {k: r[k] for k in ("ms", "global_ms", "bound_ms",
                                                           "library_ms", "share_of_bound")}
                                    for lv, r in dcndat_bwd.items()},
            "card": card}})
        bwd_ops, want_ops = {}, {}
        for prefix, by_dtype in (("", per_level_bwd), ("strided_", strided["backward"]),
                                 ("dcndat_", per_level_bwd_dcndat)):
            for dtype, rows in by_dtype.items():
                for name, r in rows.items():
                    for run, path in (("planned", r["plan"]["path"]), ("global", "global")):
                        key = f"{prefix}{dtype}_{name}_{run}_{path}"
                        bwd_ops[key] = len(r["device_ops"][run])
                        want_ops[key] = BWD_DEVICE_OPS[path][dtype]
        emit({"backward_device_ops_per_call": bwd_ops})
        if bwd_ops != want_ops:
            raise AssertionError(f"backward device operations per call {bwd_ops}, "
                                 f"expected {want_ops}")

    probes = {}
    with Phase("gather"):
        row_gather.launches = lane_gather.launches = 0
        probes["row_gather"] = gather_probe.main()
        probes["lane_gather"] = lane_gather_probe.main()
        gather_launches = {"row_gather": row_gather.launches,
                           "lane_gather": lane_gather.launches}
        emit({"main_path_launches": gather_launches})
        for name, rows in probes.items():
            if gather_launches[name] != len(rows) or not all(r["exact"] for r in rows):
                raise AssertionError(f"{name}: {gather_launches[name]} launches for "
                                     f"{len(rows)} shapes, or a result that is not exact")

    with Phase("checkpoints"):
        for name in ("DAT", "DAT_fast_teacher"):
            cfg, ckpt = PRESETS[name]
            served = load_model(cfg, ckpt, device="cuda")
            emit({"checkpoint": str(ckpt.relative_to(ROOT)), "config": name,
                  "shared_offsets": cfg.shared_offsets, "dat_samples": list(cfg.dat_samples),
                  "params": sum(p.numel() for p in served.parameters()),
                  "dtype": str(served.dtype)})
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            serve_requests(served, [((H, W), 0.5), ((H, W), 0.25)] * 2, tex, shift, name)
            path_launches[f"checkpoints_{name}"] = deformable_sample.launches
            emit({"config": name, "path_launches": deformable_sample.launches,
                  "bf16_launches": deformable_sample.bf16_launches})
            card_vs_cpu(cfg, ckpt, served, x0, x1, t5)
            torch.set_num_threads(1)
            with torch.inference_mode():
                emit({f"ms_per_frame_448x256_bf16_{name}":
                      timing.loop_ms(lambda: served(*xs), 20, warmup=5) / 20, "card": card})
            del served
            torch.cuda.empty_cache()

    with Phase("modes"):
        check_modes(model, tex, shift, path_launches)

    with Phase("eval"):
        check_eval(path_launches)

    with Phase("train"):
        train = check_train(card, path_launches)
    # Phase 10's rendered pools serve the later head_to_head runs' pools.
    later = contextlib.ExitStack()
    later.enter_context(cached_scenes(train.pop("scenes")))

    synthetic = {}
    with tempfile.TemporaryDirectory(prefix="vfi_eval_") as tmp:
        with Phase("evaluate"):
            hd, scenes = check_evaluate(Path(tmp), path_launches, synthetic)
        with Phase("serve_hd"):
            check_serve_hd(Path(tmp), hd, model, card, path_launches)

    with tempfile.TemporaryDirectory(prefix="vfi_trainer_") as tmp:
        with Phase("trainer"):
            check_trainer(Path(tmp), card, path_launches, launched_shapes, launched_backward)
        # Phase 15 trains on phase 14's tree.
        with Phase("families"):
            check_families(Path(tmp), card, path_launches, launched_shapes, launched_backward)

    with tempfile.TemporaryDirectory(prefix="vfi_variants_") as tmp:
        with Phase("variants"):
            variants = check_variants(Path(tmp), gen, card, path_launches, scenes,
                                      synthetic["DAT_fast"])
    del scenes
    later.close()
    checked_shapes |= variants["forward_held"]

    # Phase 13 runs last, so that it holds the shapes of every path, phases
    # 14's, 15's and 16's included.
    with Phase("shapes"):
        late = sorted(launched_shapes - checked_shapes)
        emit({"launched_level_shapes": sorted(launched_shapes), "checked_in_phase_2":
              len(launched_shapes & checked_shapes), "checked_here": late})
        for B2, h, w, C, G, S, st in late:
            if _index_bits(B2, h, w, C, G, S, st) == 64:
                raise AssertionError(f"a path launched the sampler at {(B2, h, w, C, G, S, st)}, "
                                     "which needs 64-bit indices: add it to WIDE_CASES")
            inputs = sampler_probe.level_inputs(gen, B2, h, w, C, G, S, 8.0, stride=st)
            err = check_sampler_case(f"launched_{B2}x{h}x{w}x{C}_g{G}_s{S}_stride{st}", *inputs,
                                     0, set(), st)
            max_err["deformable_sample"] = max(max_err["deformable_sample"], err)
            del inputs
        # The backward at every level shape a path launched it at and phase
        # 2 did not hold, on its planned path (offset scale 8, flows of 4 px).
        held = {(*case[:6], 1) for case in BACKWARD_CASES.values()} | variants["backward_held"]
        late_bwd = sorted(launched_backward - held)
        emit({"launched_backward_level_shapes": sorted(launched_backward),
              "backward_checked_in_phase_2": len(launched_backward & held),
              "backward_checked_here": late_bwd})
        for B2, h, w, C, G, S, st in late_bwd:
            if _index_bits(B2, h, w, C, G, S, st) == 64:
                raise AssertionError(f"a path launched the backward at {(B2, h, w, C, G, S, st)}, "
                                     "which needs 64-bit indices: add it to BACKWARD_CASES")
            errs = check_backward_case(gen, f"launched_{B2}x{h}x{w}x{C}_g{G}_s{S}_stride{st}",
                                       (B2, h, w, C, G, S, 8.0, 4.0), None, st)
            bwd_err = (max(bwd_err[0], errs[0]), max(bwd_err[1], errs[1]))
        torch.cuda.empty_cache()

    def total(rows, key):
        return sum(r[key] for r in rows)

    kernels = [{
        "name": "deformable_sample",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "launches": path_launches["serve"],
        "launches_per_path": {k: v for k, v in path_launches.items() if "backward" not in k},
        "max_abs_err": max_err["deformable_sample"],
        "ms": total(shared, "ms"),
        "plain_ms": total(shared, "plain_ms"),
        "bound_ms": total(shared, "bound_ms"),
        "bound_by": ("bytes" if total(shared, "bytes_ms") >= total(shared, "ops_ms")
                     else "operations"),
        "library_ms": total(shared, "library_ms"),
        "dtype": "bfloat16",
        "dcndat_request": {k: total(dcndat_fwd.values(), k) for k in (
            "ms", "plain_ms", "bound_ms", "library_ms")},
        "per_level": per_level,
        "card": card,
    }]
    bwd = list(per_level_bwd["bfloat16"].values())
    kernels.append({
        "name": "deformable_sample_backward",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "note": ("the gradient of that kernel's function, which the JAX model takes with "
                 "XLA's autodiff of _grouped_deformable_sample "
                 "(videoframeinterpolation_tpu/nn/deformable_attn.py:83)"),
        "launches": train["backward_launches"],
        "launches_per_step": train["backward_launches"] / train["steps"],
        "paths": {"smem": "grad_feat summed in shared memory (planned at every training level)",
                  "global": "grad_feat summed with global atomics (forced in phase 2 and timed "
                            "in phase 5)"},
        "launches_per_backward_path": train["backward_path_launches"],
        "launches_per_path": {"train": train["backward_launches"],
                              **{k: v for k, v in path_launches.items() if "backward" in k}},
        "max_abs_err": bwd_err[0],
        "max_err_over_max_abs": bwd_err[1],
        "ms": total(bwd, "ms"),
        "global_ms": total(bwd, "global_ms"),
        "plain_ms": total(bwd, "plain_ms"),
        "bound_ms": total(bwd, "bound_ms"),
        "bound_by": ("bytes" if total(bwd, "bytes_ms") >= total(bwd, "ops_ms")
                     else "operations"),
        "library_ms": total(bwd, "library_ms"),
        "dtype": "bfloat16",
        "dcndat_train_step": {k: total(dcndat_bwd.values(), k) for k in (
            "ms", "global_ms", "plain_ms", "bound_ms", "library_ms")},
        "per_level": per_level_bwd,
        "per_level_dcndat": per_level_bwd_dcndat,
        "card": card,
    })
    strided_fwd = strided["forward"]["stride_arm"]["bfloat16"]["lv1"]
    strided_note = ("the same kernel on a query grid of stride 2, the attn_stride variant's "
                    "level 1: JAX _grouped_deformable_sample(..., stride) "
                    "(videoframeinterpolation_tpu/nn/deformable_attn.py:83)")
    kernels.append({
        "name": "deformable_sample_strided",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "note": strided_note,
        "launches": variants["serve_strided_launches"],
        "launches_per_path": {"serve_stride_arm": variants["serve_strided_launches"],
                              "head_to_head_stride_arm": variants["train"]["strided_forward"]},
        "max_abs_err": variants["max_abs_err"],
        "ms": strided_fwd["ms"],
        "plain_ms": strided_fwd["plain_ms"],
        "bound_ms": strided_fwd["bound_ms"],
        "bound_by": "bytes" if strided_fwd["bytes_ms"] >= strided_fwd["ops_ms"] else "operations",
        "library_ms": strided_fwd["library_ms"],
        "dtype": "bfloat16",
        "per_level": strided["forward"],
        "card": card,
    })
    strided_bwd = strided["backward"]["bfloat16"]["lv1"]
    kernels.append({
        "name": "deformable_sample_backward_strided",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "note": "the backward of " + strided_note,
        "launches": variants["train"]["strided_backward"],
        "launches_per_step": variants["train"]["strided_backward"] / 20,
        "max_abs_err": variants["backward_err"][0],
        "max_err_over_max_abs": variants["backward_err"][1],
        "ms": strided_bwd["ms"],
        "global_ms": strided_bwd["global_ms"],
        "plain_ms": strided_bwd["plain_ms"],
        "bound_ms": strided_bwd["bound_ms"],
        "bound_by": "bytes" if strided_bwd["bytes_ms"] >= strided_bwd["ops_ms"] else "operations",
        "library_ms": strided_bwd["library_ms"],
        "dtype": "bfloat16",
        "per_level": strided["backward"],
        "card": card,
    })
    for name, replaces in (("row_gather", "tools/perf/pallas_gather_probe.py:11"),
                           ("lane_gather", "tools/perf/pallas_lane_gather_probe.py:14")):
        rows = probes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "videoframeinterpolation_tpu_torch/kernels/csrc/gather.cu",
            "replaces": replaces,
            "launches": gather_launches[name],
            "max_abs_err": max(max_err[name], max(r["max_abs_err"] for r in rows)),
            "ms": total(rows, "ms"),
            "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": "bytes",
            "library_ms": total(rows, "library_ms"),
            "per_shape": rows,
            "card": card,
        })
    emit({"script_seconds": round(time.perf_counter() - _T0, 3)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def serve_requests(model, requests, tex, shift, name: str) -> None:
    """Serve each ``((h, w), t)`` request through ``interp_pair``; each must
    give a uint8 ``(h, w, 3)`` frame with exactly 3 bf16 sampler launches."""
    from videoframeinterpolation_tpu_torch.interpolate import interp_pair
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample

    for i, ((h, w), t) in enumerate(requests):
        f0, f1, mid = frames(tex, h, w, shift, t)
        before, before_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
        start = time.perf_counter()
        pred = interp_pair(model, f0, f1, t)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
        launched = deformable_sample.launches - before
        launched_bf16 = deformable_sample.bf16_launches - before_bf16
        if pred.shape != (h, w, 3) or pred.dtype != np.uint8:
            raise AssertionError(f"{name} request {i}: got {pred.dtype} {pred.shape}")
        if launched != 3 or launched_bf16 != 3:
            raise AssertionError(f"{name} request {i}: {launched} sampler launches, "
                                 f"{launched_bf16} in bf16; expected 3 bf16")
        emit({"config": name, "request": i, "hw": [h, w], "t": t, "host_ms": round(host_ms, 3),
              "launches": launched, "bf16_launches": launched_bf16,
              "psnr_vs_shifted_mid": round(psnr(pred, mid), 3),
              "psnr_frame0_vs_mid": round(psnr(f0, mid), 3)})


def card_vs_cpu(cfg, ckpt, card_model, x0, x1, t):
    """One request on the card against the same checkpoint on the CPU (plain
    path): an fp32 copy of ``cfg`` within ``E2E_TOL`` max abs, and
    ``card_model`` (``cfg`` in bf16) within ``BF16_GAP_SHARE`` of the CPU's
    own bf16-vs-fp32 gap in mean abs. Returns the fp32 model on the card."""
    from videoframeinterpolation_tpu_torch.interpolate import load_model

    fp32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    torch.set_num_threads(os.cpu_count() or 1)
    model32 = load_model(fp32_cfg, ckpt, device="cuda")
    with torch.inference_mode():
        on_card = {"float32": model32(x0.cuda(), x1.cuda(), t.cuda()).cpu(),
                   "bfloat16": card_model(x0.cuda(), x1.cuda(), t.cuda()).cpu()}
        cpu, cpu_s = {}, {}
        for c in (fp32_cfg, cfg):
            start = time.perf_counter()
            cpu[c.compute_dtype] = load_model(c, ckpt, device="cpu")(x0, x1, t)
            cpu_s[c.compute_dtype] = round(time.perf_counter() - start, 3)
    shape = (1, *x0.shape[1:])
    for name, out in on_card.items():
        if not (out.dtype == torch.float32 and torch.isfinite(out).all() and out.shape == shape):
            raise AssertionError(f"card output ({name}): {out.dtype} {tuple(out.shape)} "
                                 "or non-finite")
    ckpt_name = Path(ckpt).name
    e2e_err = (on_card["float32"] - cpu["float32"]).abs().max().item()
    emit({"checkpoint": ckpt_name, "fp32_max_abs_err_vs_cpu": e2e_err,
          "mean_abs_err": (on_card["float32"] - cpu["float32"]).abs().mean().item(),
          "tol": E2E_TOL, "cpu_seconds": cpu_s["float32"]})
    if not e2e_err <= E2E_TOL:
        raise AssertionError(f"{ckpt_name}: card vs CPU, fp32: {e2e_err} > {E2E_TOL}")
    bf16_gap = (cpu["bfloat16"] - cpu["float32"]).abs().mean().item()
    bf16_err = (on_card["bfloat16"] - cpu["bfloat16"]).abs().mean().item()
    emit({"checkpoint": ckpt_name, "bf16_mean_abs_err_vs_cpu": bf16_err,
          "max_abs_err": (on_card["bfloat16"] - cpu["bfloat16"]).abs().max().item(),
          "cpu_bf16_vs_fp32_mean_abs": bf16_gap, "limit": BF16_GAP_SHARE * bf16_gap,
          "share_of_gap": bf16_err / bf16_gap, "cpu_seconds": cpu_s["bfloat16"]})
    if not bf16_err <= BF16_GAP_SHARE * bf16_gap:
        raise AssertionError(f"{ckpt_name}: card vs CPU, bf16: mean {bf16_err} > "
                             f"{BF16_GAP_SHARE} x {bf16_gap}")
    return model32


def check_modes(model, tex, shift, path_launches: dict) -> None:
    """Multi-instant serving of the student in bf16 at 448x256: the frames
    of ``multi_t_apply`` at t = 1/4, 1/2, 3/4 equal the per-instant forward
    bit for bit, with one encoder run and 3 bf16 sampler launches per
    instant (the encoder launches none); then the CLI's recursive and direct
    modes at factor 4 on a 3-frame ``.npy`` sequence write 9 frames each."""
    from videoframeinterpolation_tpu_torch import interpolate
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.models import multi_t_apply

    f0, f1, _ = frames(tex, H, W, shift, 0.5)
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None].cuda() for f in (f0, f1))
    ts = (0.25, 0.5, 0.75)
    with torch.inference_mode():
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        model.encode(x0, x1)
        encoder_launches = deformable_sample.launches
        encodes = []
        encode = model.encode
        model.encode = lambda a, b: (encodes.append(1), encode(a, b))[1]
        try:
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            direct = multi_t_apply(model, x0, x1, ts)
            torch.cuda.synchronize()
            launched, launched_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
        finally:
            del model.encode
        path_launches["modes_multi_t"] = launched
        singles = [model(x0, x1, torch.full((1, 1, 1, 1), t, device="cuda")) for t in ts]
        torch.cuda.synchronize()
    equal = [bool(torch.equal(direct[k], s)) for k, s in enumerate(singles)]
    emit({"multi_t_apply": {"ts": list(ts), "shape": list(direct.shape),
                            "equal_to_per_t_forward": equal, "encoder_runs": len(encodes),
                            "encoder_launches": encoder_launches, "launches": launched,
                            "bf16_launches": launched_bf16,
                            "max_abs_diff": max((direct[k] - s).abs().max().item()
                                                for k, s in enumerate(singles))}})
    if not all(equal):
        raise AssertionError(f"multi_t_apply differs from the per-t forward: {equal}")
    if encoder_launches or len(encodes) != 1 or (launched, launched_bf16) != (9, 9):
        raise AssertionError(f"multi_t_apply: {len(encodes)} encoder runs, encoder launches "
                             f"{encoder_launches}, {launched} launches ({launched_bf16} bf16); "
                             "expected 1, 0 and 9 bf16")

    with tempfile.TemporaryDirectory() as tmp:
        in_dir = Path(tmp) / "in"
        in_dir.mkdir()
        for i in range(3):
            np.save(in_dir / f"{i:03d}.npy", frames(tex, H, W, (i * shift[0], i * shift[1]),
                                                    0.0)[1])
        for mode in ("recursive", "direct"):
            out_dir = Path(tmp) / mode
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            interpolate.main(["--in_dir", str(in_dir), "--out_dir", str(out_dir),
                              "--factor", "4", "--mode", mode, "--device", "cuda"])
            torch.cuda.synchronize()
            written = sorted(p.name for p in out_dir.iterdir())
            shapes = {np.load(out_dir / n).shape for n in written}
            path_launches[f"modes_cli_{mode}"] = deformable_sample.launches
            emit({"cli_mode": mode, "factor": 4, "frames_in": 3, "frames_out": len(written),
                  "shapes": sorted(shapes), "launches": deformable_sample.launches,
                  "bf16_launches": deformable_sample.bf16_launches})
            if written != [f"{i:06d}.npy" for i in range(9)] or shapes != {(H, W, 3)}:
                raise AssertionError(f"--mode {mode} --factor 4 wrote {written} of {shapes}")
            if deformable_sample.bf16_launches != 18:
                raise AssertionError(f"--mode {mode}: {deformable_sample.bf16_launches} bf16 "
                                     "sampler launches; expected 18 (6 frames, 3 each)")


def check_eval(path_launches: dict) -> None:
    """The held-out evaluation of every committed checkpoint on the card in
    fp32 (32 scenes, 128x128, seed 42): each PSNR within ``EVAL_PSNR_TOL``
    dB and each SSIM within ``EVAL_SSIM_TOL`` of the JAX package's CPU fp32
    read (``JAX_CPU_FP32``); the TPU's record is printed beside it."""
    from videoframeinterpolation_tpu_torch.config import PRESETS
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.tools.eval_best import evaluate

    for name, (ref_psnr, ref_ssim) in JAX_CPU_FP32.items():
        cfg, ckpt = PRESETS[name]
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        start = time.perf_counter()
        (rec,) = evaluate(cfg, [ckpt], eval_items=32, crop=128, seed=42, device="cuda")
        seconds = time.perf_counter() - start
        path_launches[f"eval_{name}"] = deformable_sample.launches
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("the evaluation left TF32 on")
        tpu_psnr, tpu_ssim = TPU_EVAL_BEST[name]
        emit({"eval": name, "checkpoint": str(ckpt.relative_to(ROOT)), "step": rec["step"],
              "n": rec["n"], "psnr": rec["psnr"], "ssim": rec["ssim"],
              "jax_cpu_fp32": {"psnr": ref_psnr, "ssim": ref_ssim},
              "psnr_minus_jax_cpu": rec["psnr"] - ref_psnr,
              "ssim_minus_jax_cpu": rec["ssim"] - ref_ssim,
              "tpu_eval_best_jsonl": {"psnr": tpu_psnr, "ssim": tpu_ssim,
                                      "psnr_minus_tpu": rec["psnr"] - tpu_psnr,
                                      "ssim_minus_tpu": rec["ssim"] - tpu_ssim},
              "launches": deformable_sample.launches,
              "bf16_launches": deformable_sample.bf16_launches, "seconds": round(seconds, 3)})
        if rec["n"] != 32 or deformable_sample.launches != 12 or deformable_sample.bf16_launches:
            raise AssertionError(f"eval {name}: {rec['n']} items, {deformable_sample.launches} "
                                 f"launches ({deformable_sample.bf16_launches} bf16); expected "
                                 "32 items and 12 fp32 launches (4 batches of 8, 3 each)")
        if not (abs(rec["psnr"] - ref_psnr) <= EVAL_PSNR_TOL
                and abs(rec["ssim"] - ref_ssim) <= EVAL_SSIM_TOL):
            raise AssertionError(f"eval {name}: PSNR {rec['psnr']} / SSIM {rec['ssim']} against "
                                 f"JAX's CPU fp32 {ref_psnr} / {ref_ssim}")

def _render_scene(args):
    """A ``SyntheticMotion`` scene of either split at the default instant
    (run in a worker process); ``args`` is its :func:`cached_scenes` key."""
    from videoframeinterpolation_tpu_torch.data import SyntheticMotion

    hw, seed, is_train, idx = args
    return SyntheticMotion(crop_hw=hw, is_train=is_train, seed=seed, num_items=idx + 1)[idx]


def render_scenes(keys: list) -> dict:
    """``key -> item`` of each :func:`cached_scenes` key, rendered in
    :func:`render_pool` (an item is a function of its key alone)."""
    start = time.perf_counter()
    pool = render_pool()
    items = list(pool.map(_render_scene, keys, chunksize=8))
    emit({"rendered": {"scenes": len(keys), "workers": RENDER_WORKERS,
                       "seconds": round(time.perf_counter() - start, 3)}})
    return dict(zip(keys, items))


def _write_fixture(args):
    """A fixture tree, or the HD triplet (run in a worker process)."""
    from videoframeinterpolation_tpu_torch.tools import fixtures

    kind, base, hws, seed = args
    if kind == "hd":
        return fixtures.triplet(hws[0], seed)
    getattr(fixtures, f"write_{kind}")(base, hws, seed)
    return None


@contextlib.contextmanager
def cached_scenes(scenes: dict):
    """Serve ``SyntheticMotion`` items at the default instant from
    ``scenes`` (``(crop_hw, seed, is_train, idx) -> item``), rendered
    beforehand in worker processes; other items render as usual."""
    from videoframeinterpolation_tpu_torch.data.synthetic import SyntheticMotion

    render = SyntheticMotion.__getitem__

    def getitem(self, idx):
        key = (self.crop_hw, self.base_seed, self.is_train, idx)
        if self.t_range is None and self.fixed_t is None and key in scenes:
            return scenes[key]
        return render(self, idx)

    SyntheticMotion.__getitem__ = getitem
    try:
        yield
    finally:
        SyntheticMotion.__getitem__ = render


@contextlib.contextmanager
def working_directory(path: Path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def check_evaluate(tmp: Path, path_launches: dict, synthetic: dict):
    """Phase 11 (see the module docstring). Renders the synthetic scenes,
    the fixture trees and the HD triplet in worker processes; puts each
    checkpoint's ``validate_synthetic`` result in ``synthetic``; returns the
    HD triplet for phase 12 and the rendered scenes for phase 16."""
    from videoframeinterpolation_tpu_torch import evaluate
    from videoframeinterpolation_tpu_torch.eval import benchmarks
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.tools import fixtures

    hw, n = (256, 448), 64
    trees = {bench: (tmp / bench, hws, seed) for bench, (hws, seed) in FIXTURE_TREES.items()}
    (hd_hw, hd_seed) = HD_PAIR
    start = time.perf_counter()
    pool = render_pool()
    hd = pool.submit(_write_fixture, ("hd", None, [hd_hw], hd_seed))
    tree_jobs = [pool.submit(_write_fixture, (b, base, hws, seed))
                 for b, (base, hws, seed) in trees.items()]
    items = list(pool.map(_render_scene, [(hw, 42, False, i) for i in range(n)]))
    hd = hd.result()
    for job in tree_jobs:
        job.result()
    fixtures.write_snu_triplets(tmp / "snu_hd", [hd])
    emit({"rendered": {"scenes": n, "trees": len(tree_jobs) + 1, "workers": RENDER_WORKERS,
                       "seconds": round(time.perf_counter() - start, 3)}})
    scenes = {(hw, 42, False, i): item for i, item in enumerate(items)}

    # validate_synthetic through the entry point, 64 scenes; the first
    # SYNTHETIC_ITEMS of them (the same batches of 4) are held to JAX.
    per_item = []
    scores = benchmarks._scores

    def recording(pred, gt, report_ssim, psnrs, ssims):
        n0 = len(psnrs)
        scores(pred, gt, report_ssim, psnrs, ssims)
        per_item.extend(zip(psnrs[n0:], ssims[n0:]))

    benchmarks._scores = recording
    try:
        with cached_scenes(scenes):
            for name, (ref_psnr, ref_ssim) in JAX_SYNTHETIC.items():
                per_item.clear()
                deformable_sample.launches = deformable_sample.bf16_launches = 0
                start = time.perf_counter()
                res = evaluate.main(["--config", name, "--benchmark", "synthetic", "--ssim",
                                     "--device", "cuda"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - start
                synthetic[name] = res
                path_launches[f"evaluate_synthetic_{name}"] = deformable_sample.launches
                head = per_item[:SYNTHETIC_ITEMS]
                got_psnr = float(np.mean([p for p, _ in head]))
                got_ssim = float(np.mean([q for _, q in head]))
                emit({"evaluate_synthetic": name, "items": len(per_item), **res,
                      f"first_{SYNTHETIC_ITEMS}": {"psnr": got_psnr, "ssim": got_ssim},
                      "jax_cpu_fp32": {"psnr": ref_psnr, "ssim": ref_ssim},
                      "psnr_minus_jax_cpu": got_psnr - ref_psnr,
                      "ssim_minus_jax_cpu": got_ssim - ref_ssim,
                      "launches": deformable_sample.launches,
                      "bf16_launches": deformable_sample.bf16_launches,
                      "seconds": round(seconds, 3)})
                if (len(per_item) != n or deformable_sample.launches != 3 * n // 4
                        or deformable_sample.bf16_launches):
                    raise AssertionError(f"synthetic {name}: {len(per_item)} items, "
                                         f"{deformable_sample.launches} launches "
                                         f"({deformable_sample.bf16_launches} bf16); expected "
                                         f"{n} items and 3 fp32 launches per batch of 4")
                if not (abs(got_psnr - ref_psnr) <= EVAL_PSNR_TOL
                        and abs(got_ssim - ref_ssim) <= EVAL_SSIM_TOL):
                    raise AssertionError(f"synthetic {name}: PSNR {got_psnr} / SSIM {got_ssim} "
                                         f"against JAX's CPU fp32 {ref_psnr} / {ref_ssim}")
    finally:
        benchmarks._scores = scores

    # The dataset loops on the fixture trees, the shipped student in fp32.
    for bench, (base, hws, _) in trees.items():
        # Vimeo90K in batches of 4; UCF101 one triplet per forward; SNU-FILM
        # one triplet in each of its first 3 levels and every one in the last.
        forwards = {"vimeo90k": -(-len(hws) // 4), "ucf101": len(hws), "snu": 3 + len(hws)}[bench]
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        with working_directory(base):
            res = evaluate.main(["--benchmark", bench, "--device", "cuda"])
        torch.cuda.synchronize()
        path_launches[f"evaluate_{bench}"] = deformable_sample.launches
        ref = JAX_TREES[bench]
        diffs = {k: res[k] - v for k, v in ref.items()} if res.keys() == ref.keys() else None
        emit({"evaluate_tree": bench, **res, "jax_cpu_fp32": ref, "minus_jax_cpu": diffs,
              "launches": deformable_sample.launches})
        if diffs is None or max(abs(d) for d in diffs.values()) > EVAL_PSNR_TOL:
            raise AssertionError(f"{bench} tree: {res} against JAX's CPU fp32 {ref}")
        if deformable_sample.launches != 3 * forwards or deformable_sample.bf16_launches:
            raise AssertionError(f"{bench} tree: {deformable_sample.launches} launches; "
                                 f"expected {3 * forwards} fp32")
    return hd, scenes


def check_serve_hd(tmp: Path, hd, model, card: str, path_launches: dict) -> None:
    """Phase 12 (see the module docstring)."""
    from videoframeinterpolation_tpu_torch import evaluate, interpolate
    from videoframeinterpolation_tpu_torch.config import DAT_fast
    from videoframeinterpolation_tpu_torch.data import decode_png, encode_png
    from videoframeinterpolation_tpu_torch.interpolate import SHIPPED_STUDENT, load_model
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.tools.perf import timing

    f0, mid, f1 = hd
    pair = tmp / "hd_pair"
    pair.mkdir()
    for name, img in (("000.png", f0), ("001.png", f1)):
        (pair / name).write_bytes(encode_png(img))
    made = []
    make_infer = interpolate.make_infer

    def recording_make_infer(m, tile=0):
        made.append(make_infer(m, tile))
        return made[-1]

    interpolate.make_infer = evaluate.make_infer = recording_make_infer
    try:
        # bf16, pair mode through the entry point.
        out = tmp / "hd_mid.png"
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        interpolate.main(["--frame0", str(pair / "000.png"), "--frame1", str(pair / "001.png"),
                          "--out", str(out), "--tile", str(HD_TILE), "--device", "cuda"])
        torch.cuda.synchronize()
        launches, bf16_launches = deformable_sample.launches, deformable_sample.bf16_launches
        path_launches["serve_hd_tiled"] = launches
        tiled_plans = list(made[-1].plans)
        tiled = decode_png(out.read_bytes())
        full = interpolate.interp_pair(model, f0, f1, 0.5)
        emit({"serve_hd": "interpolate --tile", "hw": list(f0.shape[:2]), "dtype": "bfloat16",
              "plans": tiled_plans, "jax_plan": JAX_HD_PLAN["interpolate"],
              "launches": launches, "bf16_launches": bf16_launches,
              "psnr_tiled_vs_full_frame": psnr(tiled, full),
              "psnr_tiled_vs_true_mid": psnr(tiled, mid), "psnr_full_vs_true_mid": psnr(full, mid)})
        if tiled_plans != [JAX_HD_PLAN["interpolate"]] or tiled.shape != f0.shape:
            raise AssertionError(f"HD bf16: plans {tiled_plans} against JAX's "
                                 f"{JAX_HD_PLAN['interpolate']}, frame {tiled.shape}")
        if full.shape != f0.shape or not psnr(tiled, full) >= HD_SEAM_PSNR:
            raise AssertionError(f"HD bf16: full frame {full.shape}, tiled against it "
                                 f"{psnr(tiled, full)} dB < {HD_SEAM_PSNR}")
        if (launches, bf16_launches) != (6, 6):
            raise AssertionError(f"HD bf16: {launches} launches "
                                 f"({bf16_launches} bf16); expected 3 for the probe and 3 for "
                                 "the one chunk of tiles, in bf16")

        # ms per PNG decode on this machine's host (the port's own files: filter 0).
        vimeo = tmp / "vimeo90k" / "datasets" / "vimeo_triplet" / "sequences"
        decode_ms = {}
        for size, path in (("1280x720", pair / "000.png"),
                           ("448x256", sorted(vimeo.glob("*/*/im1.png"))[0])):
            data = path.read_bytes()
            start = time.perf_counter()
            for _ in range(5):
                decode_png(data)
            decode_ms[size] = (time.perf_counter() - start) * 1e3 / 5
        emit({"png_decode_ms_host": decode_ms, "host_of": card})

        # ms per pair on the card, tiled and full-frame, bf16.
        x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None].cuda() for f in (f0, f1))
        t5 = torch.full((1, 1, 1, 1), 0.5, device="cuda")
        infer = make_infer(model, HD_TILE)
        with torch.inference_mode():
            times = {"tiled": timing.loop_ms(lambda: infer(x0, x1, t5), 5, warmup=2) / 5,
                     "full_frame": timing.loop_ms(lambda: model(x0, x1, t5), 5, warmup=2) / 5}
        emit({"ms_per_pair_720x1280_bf16": times, "card": card})

        # fp32: the SNU-FILM loop over the HD triplet through the entry point.
        made.clear()
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        with working_directory(tmp / "snu_hd"):
            res = evaluate.main(["--benchmark", "snu", "--tile", str(HD_TILE),
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        path_launches["evaluate_snu_tile"] = deformable_sample.launches
        eval_plans = list(made[-1].plans)
        emit({"serve_hd": "evaluate --benchmark snu --tile", "dtype": "float32", **res,
              "plans": eval_plans, "jax_plan": JAX_HD_PLAN["evaluate"],
              "launches": deformable_sample.launches,
              "bf16_launches": deformable_sample.bf16_launches})
        if eval_plans != [JAX_HD_PLAN["evaluate"]]:
            raise AssertionError(f"HD fp32: plans {eval_plans} against JAX's "
                                 f"{JAX_HD_PLAN['evaluate']}")
        if deformable_sample.launches != 24 or deformable_sample.bf16_launches:
            raise AssertionError(f"HD fp32 loop: {deformable_sample.launches} launches; expected "
                                 "24 fp32 (4 levels, 3 for the probe and 3 for the tiles)")

        # The tiled fp32 frame, card against the CPU.
        fp32 = dataclasses.replace(DAT_fast, compute_dtype="float32")
        frames, plans, seconds = {}, {}, {}
        for device in ("cuda", "cpu"):
            torch.set_num_threads((os.cpu_count() or 1) if device == "cpu" else 1)
            m = load_model(fp32, SHIPPED_STUDENT, device=device)
            infer = make_infer(m, HD_TILE)
            start = time.perf_counter()
            with torch.inference_mode():
                frames[device] = infer(x0.to(device), x1.to(device), t5.to(device)).cpu()
            seconds[device] = round(time.perf_counter() - start, 3)
            plans[device] = list(infer.plans)
            del m, infer
        torch.set_num_threads(1)
        err = (frames["cuda"] - frames["cpu"]).abs().max().item()
        emit({"serve_hd_fp32_tiled_card_vs_cpu": err, "tol": E2E_TOL, "plans": plans,
              "seconds": seconds})
        if not (err <= E2E_TOL and torch.isfinite(frames["cuda"]).all()
                and frames["cuda"].shape == (1, *f0.shape)
                and plans["cuda"] == plans["cpu"] == [JAX_HD_PLAN["evaluate"]]):
            raise AssertionError(f"HD fp32 tiled frame, card vs CPU: {err} > {E2E_TOL}, "
                                 f"or plans {plans}")

        # Every instant of a factor-4 direct sequence, tiled.
        out_dir = tmp / "hd_direct"
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        interpolate.main(["--in_dir", str(pair), "--out_dir", str(out_dir), "--factor", "4",
                          "--mode", "direct", "--tile", str(HD_TILE), "--device", "cuda"])
        torch.cuda.synchronize()
        path_launches["serve_hd_direct"] = deformable_sample.launches
        written = sorted(p.name for p in out_dir.iterdir())
        shapes = {decode_png((out_dir / n).read_bytes()).shape for n in written}
        emit({"serve_hd": "interpolate --mode direct --factor 4 --tile", "frames_out": len(written),
              "shapes": sorted(shapes), "launches": deformable_sample.launches,
              "bf16_launches": deformable_sample.bf16_launches})
        if written != [f"{i:06d}.png" for i in range(5)] or shapes != {f0.shape}:
            raise AssertionError(f"HD direct: wrote {written} of {shapes}")
        if deformable_sample.bf16_launches != 12:
            raise AssertionError(f"HD direct: {deformable_sample.bf16_launches} bf16 launches; "
                                 "expected 12 (3 for the probe, 9 for 3 instants of one chunk)")
    finally:
        interpolate.make_infer = evaluate.make_infer = make_infer


def check_card_figures() -> None:
    """The card's figures that ``kernels/build.py`` compiles the kernels
    with and the backward's plan reads, against what the card reports (each
    figure that this PyTorch's device properties carry; the SM count at
    least)."""
    from videoframeinterpolation_tpu_torch.kernels import build

    props = torch.cuda.get_device_properties(0)
    want = {"multi_processor_count": build.SMS,
            "max_threads_per_multi_processor": build.THREADS_PER_SM,
            "shared_memory_per_multiprocessor": build.SMEM_PER_SM,
            "shared_memory_per_block_optin": build.SMEM_PER_BLOCK}
    got = {k: getattr(props, k) for k in want if hasattr(props, k)}
    emit({"card_figures": got, "build": want})
    if "multi_processor_count" not in got or any(got[k] != want[k] for k in got):
        raise AssertionError(f"the card's figures {got} are not the build's {want}")


def check_backward(gen) -> tuple[float, float]:
    """The sampler's backward at ``BACKWARD_CASES`` in fp32 and bf16, on the
    path ``_backward_plan`` picks (shared memory at every case) and on the
    global path forced, each at the widths the wrapper picks and every
    narrower width on both index widths, against
    ``deformable_sample_backward_plain`` (:func:`check_backward_case`).
    Raises if a (path, dtype, width, index width) instance never ran, or if
    the card's figures are not those the plan reads
    (:func:`check_card_figures`). Returns the largest fp32 error, absolute
    and relative to its gradient's max abs."""
    check_card_figures()
    reached, worst, worst_abs = set(), 0.0, 0.0
    for name, case in BACKWARD_CASES.items():
        err_abs, err = check_backward_case(gen, name, case, reached)
        worst_abs, worst = max(worst_abs, err_abs), max(worst, err)
    need = {(path, dt, v, b) for path in ("smem", "global") for b in (32, 64)
            for dt, widths in (("torch.float32", (16, 8, 4)), ("torch.bfloat16", (16, 8, 4, 2)))
            for v in widths}
    if need - reached:
        raise AssertionError(f"backward instances never run: {sorted(need - reached, key=str)}")
    emit({"backward_paths_checked": len(need), "max_abs_err_fp32": worst_abs,
          "max_err_over_max_abs_fp32": worst})
    torch.cuda.empty_cache()
    return worst_abs, worst


def check_backward_case(gen, name: str, case: tuple, reached: set | None,
                        stride: int = 1) -> tuple[float, float]:
    """The backward at one ``(B2, h, w, C, G, S, offset scale, flow
    magnitude)`` case (``h x w`` the feature grid, the queries on the grid
    of ``stride``) in fp32 and bf16 against
    ``deformable_sample_backward_plain``: on the planned path at the width
    the wrapper picks, twice (``grad_residual`` and ``grad_flow``, summed
    without atomics, must be equal bit for bit over the two; ``grad_feat``,
    summed with atomics, is held to the tolerance only); with ``reached``
    (a set that collects the instances run), also on the global path forced
    and at every narrower width on both index widths. Returns the largest
    fp32 error, absolute and relative to its gradient's max abs."""
    from videoframeinterpolation_tpu_torch.kernels import (
        deformable_sample, deformable_sample_backward_plain)
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        BackwardPlan, _backward_plan, _launch_backward, _vector_bytes)
    from videoframeinterpolation_tpu_torch.tools.perf.sampler_probe import level_inputs

    B2, h, w, C, G, S, scale, flow_mag = case
    worst, worst_abs = 0.0, 0.0
    feat, flow, res = level_inputs(gen, B2, h, w, C, G, S, scale, flow_mag, stride)
    if name == "integer":
        flow, res = torch.round(flow), torch.round(res)
    if name == "one_pixel":
        gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                                torch.arange(w, device="cuda", dtype=torch.float32),
                                indexing="ij")
        flow = torch.stack([3.25 - gx, 2.5 - gy], -1).expand(B2, h, w, 2).contiguous()
    grad_out = torch.randn((B2, S, h * w // stride ** 2, C), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        args = [x.to(dtype).contiguous() for x in (feat, flow, res, grad_out)]
        ref = deformable_sample_backward_plain(*args, G, stride)
        plan = _backward_plan(B2, h, w, C, G, S, stride)
        width0 = _vector_bytes(C, G, args[0].element_size(), args[0].data_ptr(),
                               args[3].data_ptr())
        before = deformable_sample.backward_launches
        planned = _launch_backward(*args, G, stride=stride)
        again = _launch_backward(*args, G, stride=stride)
        checked = {(plan.path, width0, plan.index_bits): planned}
        for path in (dict.fromkeys((plan.path, "global")) if reached is not None else ()):
            forced = plan if path == plan.path else BackwardPlan("global", 0, 0, plan.index_bits)
            width = width0
            while width >= args[0].element_size():
                for bits in (32, 64):
                    if (path, width, bits) not in checked:
                        checked[path, width, bits] = _launch_backward(
                            *args, G, width, bits, forced, stride=stride)
                width //= 2
        torch.cuda.synchronize()
        if deformable_sample.backward_launches != before + len(checked) + 1:
            raise AssertionError(f"backward launches not counted one per call ({name})")
        repro = torch.equal(planned[1], again[1]) and torch.equal(planned[2], again[2])
        if not repro:
            raise AssertionError(f"backward, case {name} {dtype}: grad_flow or "
                                 "grad_residual differ between two launches")
        errs = {}
        for (path, width, bits), got in checked.items():
            if reached is not None:
                reached.add((path, str(dtype), width, bits))
            for g, r, which in zip(got, ref, ("feat", "flow", "residual")):
                if dtype == torch.float32:
                    err = (g - r).abs().max().item()
                    worst_abs = max(worst_abs, err)
                    scale_ = r.abs().max().item()
                    ok = err <= BWD_FP32_TOL * scale_
                    errs[which] = max(errs.get(which, 0.0), err / scale_ if scale_ else err)
                else:
                    err, beyond, ok = bf16_backward_check(g, r)
                    errs[which] = max(errs.get(which, 0.0), err)
                    key = f"{which}_beyond_1_ulp"
                    errs[key] = errs.get(key, 0) + beyond
                if not ok:
                    raise AssertionError(f"backward vs plain, case {name} {dtype} {path} "
                                         f"V={width} {bits}-bit, grad_{which}: {err}")
        if dtype == torch.float32:
            worst = max(worst, *errs.values())
        emit({"case": f"backward_{name}", "dtype": str(dtype), "shape": list(res.shape),
              "stride": stride, "plan": plan._asdict(), "vector_bytes": width0,
              "instances": sorted(checked), "coordinate_gradients_reproducible": repro,
              ("max_err_over_max_abs" if dtype == torch.float32 else "max_err_in_ulps"):
              errs})
        del args, ref, checked, planned, again
    del feat, flow, res, grad_out
    return worst_abs, worst


def _leaves(tree, prefix=""):
    """``path -> numpy leaf`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def counting_teacher_launches(make_loss, counter: list):
    """``make_loss`` (a ``make_distill_loss_fn``) that adds the sampler
    launches of each of the teacher's forwards to ``counter[0]``, read
    around each call by module hooks."""
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample

    def counting_loss_fn(model, teacher, cfg, distill_w):
        mark = []
        teacher.register_forward_pre_hook(lambda *_: mark.append(deformable_sample.launches))
        teacher.register_forward_hook(lambda *_: counter.__setitem__(
            0, counter[0] + deformable_sample.launches - mark.pop()))
        return make_loss(model, teacher, cfg, distill_w)

    return counting_loss_fn


def check_train(card: str, path_launches: dict) -> dict:
    """Phase 10 (see the module docstring). Returns the recipe's backward
    launches and its number of steps."""
    import shutil

    from videoframeinterpolation_tpu_torch.config import DAT_fast, PRESETS
    from videoframeinterpolation_tpu_torch.interpolate import SHIPPED_STUDENT, load_model
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.models import create_model
    from videoframeinterpolation_tpu_torch.tools import head_to_head
    from videoframeinterpolation_tpu_torch.tools.eval_best import build_pool
    from videoframeinterpolation_tpu_torch.train import (
        create_train_state, make_distill_loss_fn, read_flax_state, state_from_flax,
        state_to_flax)

    student_tree = read_flax_state(SHIPPED_STUDENT)
    t_cfg, t_ckpt = PRESETS["DAT_fast_teacher"]
    # (a) one fp32 step, card against CPU.
    cfg32 = dataclasses.replace(DAT_fast, compute_dtype="float32", last_lr_decay_iter=24000,
                                warmup_steps=500)
    batch_np = build_pool(2, (128, 128), 42, is_train=True)
    step = {}
    for run in ("cuda", "cpu", "cpu_noise"):
        device = run.partition("_")[0]
        torch.set_num_threads((os.cpu_count() or 1) if device == "cpu" else 1)
        teacher = load_model(dataclasses.replace(t_cfg, compute_dtype="float32"), t_ckpt,
                             device=device)
        state = create_train_state(create_model(cfg32, torch.float32).to(device), cfg32)
        state_from_flax(student_tree, state)
        if run == "cpu_noise":
            noise = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for prm in state.model.parameters():
                    prm.mul_(1 + 2.0 ** -24 * torch.randn(prm.shape, generator=noise))
        loss_fn = make_distill_loss_fn(state.model, teacher, cfg32, 1.0)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        deformable_sample.launches = deformable_sample.backward_launches = 0
        start = time.perf_counter()
        total, _ = loss_fn(batch)
        total.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in state.params.items()}
        state.apply_gradients()
        if device == "cuda":
            torch.cuda.synchronize()
            if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("TF32 is on: the fp32 step would not compute fp32")
            path_launches["train_step_fp32"] = deformable_sample.launches
            path_launches["train_step_fp32_backward"] = deformable_sample.backward_launches
        step[run] = {"loss": total.item(), "grads": grads,
                        "tree": _leaves(state_to_flax(state)),
                        "seconds": time.perf_counter() - start}
        del state, teacher, loss_fn, batch, total
    torch.set_num_threads(1)
    on_card, cpu = step["cuda"], step["cpu"]
    loss_err = abs(on_card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    largest = max(g.abs().max().item() for g in cpu["grads"].values())

    def per_param(grads):
        """The largest gradient error of any parameter, of its max abs
        (floored at 1% of the largest), and that parameter."""
        return max(((grads[k] - g).abs().max().item() / max(g.abs().max().item(),
                                                             0.01 * largest), k)
                   for k, g in cpu["grads"].items())

    def whole(grads):
        return (torch.cat([(grads[k] - g).flatten() for k, g in cpu["grads"].items()]).norm()
                / torch.cat([g.flatten() for g in cpu["grads"].values()]).norm()).item()

    grad_err = whole(on_card["grads"])
    state_err = {part: float(max(np.abs(on_card["tree"][k] - v).max()
                                 for k, v in cpu["tree"].items() if k.startswith(part)))
                 for part in ("params/", "opt_state/0/mu/", "opt_state/0/nu/")}
    emit({"train_step_fp32_card_vs_cpu": {
        "loss_card": on_card["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_err,
        "grad_rel_l2_err": grad_err,
        "grad_rel_l2_cpu_under_noise": whole(step["cpu_noise"]["grads"]),
        "grad_err_over_max_abs_per_param": per_param(on_card["grads"]),
        "cpu_under_noise_err_over_max_abs_per_param": per_param(step["cpu_noise"]["grads"]),
        "state_max_abs_err": state_err,
        "launches": path_launches["train_step_fp32"],
        "backward_launches": path_launches["train_step_fp32_backward"],
        "card_seconds": on_card["seconds"], "cpu_seconds": cpu["seconds"]}})
    if not (loss_err <= STEP_LOSS_REL_TOL and grad_err <= STEP_GRAD_TOL
            and max(state_err.values()) <= STEP_STATE_TOL):
        raise AssertionError(f"fp32 step, card vs CPU: loss {loss_err}, gradients {grad_err}, "
                             f"state {state_err}")
    if (path_launches["train_step_fp32"], path_launches["train_step_fp32_backward"]) != (6, 3):
        raise AssertionError(f"fp32 step: {path_launches['train_step_fp32']} forward and "
                             f"{path_launches['train_step_fp32_backward']} backward launches; "
                             "expected 6 (student and teacher) and 3")
    del step, on_card, cpu

    # (b) the recipe, resumed at step 14500 for 500 steps; (c) its checkpoint.
    out_dir = Path(tempfile.mkdtemp(prefix="vfi_train_"))
    try:
        args = ["--model", "DATwConstantnCv1", "--shared", "--samples", "8,8,2",
                "--distill_from", str(t_ckpt), "--teacher_shared", "--teacher_samples", "8,16,8",
                "--distill_w", "1.0", "--steps", "24000", "--warmup", "500", "--resume",
                "--stop_at", "15000", "--out_dir", str(out_dir), "--device", "cuda"]
        parsed = head_to_head.parse_args(args)
        tag = head_to_head.result_tag(parsed)
        shutil.copyfile(SHIPPED_STUDENT, out_dir / f"{tag}.ckpt")
        # The recipe's training pool and held-out pool, rendered in worker
        # processes (the tool renders them on one core); later phases'
        # head_to_head pools are parts of them.
        crop = (parsed.crop, parsed.crop)
        scenes = render_scenes([(crop, parsed.seed, True, i) for i in range(parsed.pool)]
                               + [(crop, parsed.seed, False, i)
                                  for i in range(parsed.eval_items)])
        teacher_launches = [0]
        make_loss = head_to_head.make_distill_loss_fn
        head_to_head.make_distill_loss_fn = counting_teacher_launches(make_loss,
                                                                      teacher_launches)
        reset_sampler_counts()
        try:
            with cached_scenes(scenes):
                out = head_to_head.main(args)
        finally:
            head_to_head.make_distill_loss_fn = make_loss
        torch.cuda.synchronize()
        launches = {"forward": deformable_sample.launches,
                    "bf16_forward": deformable_sample.bf16_launches,
                    "teacher_forward": teacher_launches[0],
                    "backward": deformable_sample.backward_launches,
                    "backward_by_path": dict(deformable_sample.backward_path_launches)}
        path_launches["train_recipe"] = launches["forward"]
        path_launches["train_recipe_backward"] = launches["backward"]
        records = out["records"]
        evals = [r for r in records if r["event"] == "eval"]
        steps = out["state"].step - 14500
        emit({"train_recipe": {"events": [r["event"] for r in records], "eval": evals,
                               "final": records[-1], "record_15000": RECORD_15000,
                               "steps": steps, "launches": launches,
                               "ms_per_step": out["ms_per_step"],
                               "peak_memory_bytes": out["peak_memory_bytes"], "card": card}})
        if ([r["event"] for r in records] != ["resume", "eval", "stop"]
                or records[0]["step"] != 14500 or evals[0]["step"] != 15000 or steps != 500):
            raise AssertionError(f"recipe events {records}")
        loss, psnr_ = evals[0]["train_loss"], evals[0]["val_psnr"]
        if not (abs(loss - RECORD_15000["train_loss"])
                <= TRAIN_LOSS_REL_TOL * RECORD_15000["train_loss"]
                and abs(psnr_ - RECORD_15000["val_psnr"]) <= TRAIN_PSNR_TOL):
            raise AssertionError(f"step 15000: train_loss {loss}, PSNR {psnr_} against the "
                                 f"record {RECORD_15000}")
        expect = {"backward": 3 * steps, "backward_smem": 3 * steps, "teacher_forward": 3 * steps,
                  "student_forward": 3 * steps, "eval_forward": 2 * 12}
        got = {"backward": launches["backward"],
               "backward_smem": launches["backward_by_path"]["smem"],
               "teacher_forward": launches["teacher_forward"],
               "student_forward": launches["bf16_forward"] - launches["teacher_forward"],
               "eval_forward": launches["forward"] - launches["bf16_forward"]}
        emit({"train_recipe_launches": got, "expected": expect})
        if got != expect:
            raise AssertionError(f"recipe launches {got}, expected {expect}")
        disk = _leaves(read_flax_state(out_dir / f"{tag}.ckpt"))
        mem = _leaves(state_to_flax(out["state"]))
        same = disk.keys() == mem.keys() and all(
            disk[k].dtype == mem[k].dtype and np.array_equal(disk[k], mem[k]) for k in mem)
        emit({"train_checkpoint_read_back_equal": same, "leaves": len(mem)})
        if not same:
            raise AssertionError("the written checkpoint differs from the in-memory state")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"backward_launches": launches["backward"], "steps": steps,
            "backward_path_launches": launches["backward_by_path"], "scenes": scenes}


def _write_train_sequence(args):
    """One training sequence of phase 14's tree (run in a worker process)."""
    from videoframeinterpolation_tpu_torch.tools import fixtures

    root, index, hw, seed = args
    fixtures.write_vimeo90k_train_sequence(root, index, hw, seed)


_render_pool = None


def render_pool() -> concurrent.futures.ProcessPoolExecutor:
    """The spawned worker processes that render every phase's scenes and
    trees, started at the first render and reused by the later ones (each
    spawn imports torch, which cost a pool of its own 20-30 s on the card's
    host). A phase renders only within itself, so the workers sit idle
    while another phase is timed; :func:`stop_render_pool` stops them."""
    global _render_pool
    if _render_pool is None:
        _render_pool = concurrent.futures.ProcessPoolExecutor(
            RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return _render_pool


def stop_render_pool() -> None:
    """Stop :func:`render_pool`'s workers, dropping the work not yet started."""
    global _render_pool
    if _render_pool is not None:
        _render_pool.shutdown(cancel_futures=True)
        _render_pool = None


def child(kind: str, out: str, argv: list[str]) -> int:
    """``python3 chip_smoke.py --child train|evaluate OUT -- ARGS``: run the
    train or the evaluation entry point's ``main(ARGS)`` in this process,
    with the sampler's level shapes recorded and its counts set to 0 just
    before, and write to OUT what it gave: the launches (the teacher's
    forwards counted around each of its calls), the steps, peak memory and
    the profile summary of a training run; the scores of an evaluation."""
    sys.path.insert(0, str(ROOT))
    from videoframeinterpolation_tpu_torch.kernels import window_sample
    from videoframeinterpolation_tpu_torch.kernels.window_sample import deformable_sample

    forward, backward = record_level_shapes(window_sample)
    result = {}
    if kind == "evaluate":
        from videoframeinterpolation_tpu_torch import evaluate

        result["scores"] = evaluate.main(argv)
    elif kind == "train":
        from videoframeinterpolation_tpu_torch.train import __main__ as cli
        from videoframeinterpolation_tpu_torch.train import trainer as trainer_mod

        teacher_launches = [0]
        trainer_mod.make_distill_loss_fn = counting_teacher_launches(
            trainer_mod.make_distill_loss_fn, teacher_launches)
        # The launches of validation and image summaries, read around them.
        outside = {"validate": 0, "_log_images": 0}
        for name in outside:
            def counted(self, *args, _name=name, _fn=getattr(trainer_mod.Trainer, name)):
                before = deformable_sample.launches
                out = _fn(self, *args)
                outside[_name] += deformable_sample.launches - before
                return out

            setattr(trainer_mod.Trainer, name, counted)
        reset_sampler_counts()
        torch.cuda.reset_peak_memory_stats()
        trainer = cli.main(argv)
        torch.cuda.synchronize()
        result.update(
            steps=trainer.state.step, launches=deformable_sample.launches,
            bf16_launches=deformable_sample.bf16_launches,
            teacher_launches=teacher_launches[0], validation_launches=outside["validate"],
            image_launches=outside["_log_images"], backward_launches=deformable_sample.backward_launches,
            backward_path_launches=dict(deformable_sample.backward_path_launches),
            peak_memory_bytes=torch.cuda.max_memory_allocated(), profile=trainer.profile)
    else:
        raise SystemExit(f"unknown child {kind!r}")
    result.update(forward_shapes=sorted(forward), backward_shapes=sorted(backward))
    Path(out).write_text(json.dumps(result))
    return 0


def start_child(kind: str, out: Path, argv: list[str], cwd: Path,
                log: Path) -> subprocess.Popen:
    """Start :func:`child` in a new process, its output to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--child", kind,
                                 str(out), "--", *argv], cwd=cwd, stdout=f,
                                stderr=subprocess.STDOUT)


def finish_child(proc: subprocess.Popen, out: Path, log: Path, timeout: float) -> dict:
    """Wait for a child; raise with the end of its log unless it exited 0."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{' '.join(proc.args[3:5])} ran over {timeout} s:\n"
                             f"{log.read_text()[-3000:]}") from None
    if rc != 0:
        raise AssertionError(f"{' '.join(proc.args[3:5])} exited {rc}:\n"
                             f"{log.read_text()[-3000:]}")
    return json.loads(out.read_text())


def _sets(pairs: list[str]) -> list[str]:
    return [arg for kv in pairs for arg in ("--set", kv)]


def _train_records(run: Path) -> list[dict]:
    """The training steps' records of a run's ``metrics.jsonl`` (complete
    lines only: the run may be writing)."""
    lines = (run / "metrics.jsonl").read_text().split("\n")[:-1]
    return [r for r in map(json.loads, lines) if "train/total_loss" in r]


def _param_leaves(path: Path) -> np.ndarray:
    """Every parameter of a checkpoint, concatenated as float64."""
    from videoframeinterpolation_tpu_torch.train import read_flax_msgpack

    leaves = _leaves(read_flax_msgpack(path))
    return np.concatenate([leaves[k].astype(np.float64).ravel() for k in sorted(leaves)])


def check_trainer(tmp: Path, card: str, path_launches: dict, launched: set,
                  launched_backward: set) -> None:
    """Phase 14 (see the module docstring)."""
    from videoframeinterpolation_tpu_torch import evaluate
    from videoframeinterpolation_tpu_torch.config import Config
    from videoframeinterpolation_tpu_torch.data import Vimeo90KwFlow, decode_png, native
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.models import create_model
    from videoframeinterpolation_tpu_torch.tools import fixtures
    from videoframeinterpolation_tpu_torch.train import (CheckpointManager, create_train_state,
                                                         state_from_flax, state_to_flax)

    start = time.perf_counter()
    native.load_library()
    emit({"native_data_path_built_seconds": round(time.perf_counter() - start, 3)})
    n_train, n_test, hw, seed = (TRAINER_TREE[k] for k in ("train", "test", "hw", "seed"))
    root = tmp / "datasets" / "vimeo_triplet"
    start = time.perf_counter()
    pool = render_pool()
    test = pool.submit(_write_fixture, ("vimeo90k", tmp, [hw] * n_test, seed))
    list(pool.map(_write_train_sequence, [(root, i, hw, seed) for i in range(n_train)]))
    test.result()
    fixtures.write_vimeo90k_trainlist(root, n_train)
    emit({"trainer_tree": {"train": n_train, "test": n_test, "hw": list(hw),
                           "workers": RENDER_WORKERS,
                           "seconds": round(time.perf_counter() - start, 3)}})
    # The data path on this host, one thread: ms per training item (three
    # PNG decodes, two .flo reads, the augmentation) on the native and the
    # numpy path, and per PNG decode.
    recipe = Config.from_yaml(ROOT / TRAINER_RECIPE, teacher_ckpt=str(ROOT / TRAINER_TEACHER))
    item_ms = {}
    for name, use_native in (("native", True), ("numpy", False)):
        ds = Vimeo90KwFlow(str(root), crop_hw=(recipe.crop_h, recipe.crop_w), seed=seed,
                           use_native=use_native)
        ds[0]
        start = time.perf_counter()
        for i in range(DATA_TIMED_ITEMS):
            ds[i % len(ds)]
        item_ms[name] = 1e3 * (time.perf_counter() - start) / DATA_TIMED_ITEMS
    png = (root / "sequences" / fixtures.VIMEO_TRAIN_NAME.format(1) / "im1.png").read_bytes()
    start = time.perf_counter()
    for _ in range(DATA_TIMED_ITEMS):
        decode_png(png)
    item_ms["png_decode_256x448"] = 1e3 * (time.perf_counter() - start) / DATA_TIMED_ITEMS
    emit({"data_path_ms_per_item_one_thread": item_ms, "items": DATA_TIMED_ITEMS})

    cli = ["--config", str(ROOT / TRAINER_RECIPE), "--set", f"teacher_ckpt={ROOT / TRAINER_TEACHER}",
           "--set", f"root={root}", "--device", "cuda"]

    def run(kind, name, argv, timeout=600):
        out, log = tmp / f"{name}.json", tmp / f"{name}.log"
        return finish_child(start_child(kind, out, argv, tmp, log), out, log, timeout)

    torch.cuda.empty_cache()
    # Run A: the recipe, profiled.
    start = time.perf_counter()
    a = run("train", "run_a", ["--exp_name", "A", *cli, *_sets(RUN_A),
                               "--profile_steps", ",".join(map(str, PROFILE_STEPS))])
    a_seconds = time.perf_counter() - start
    exp = tmp / "exps" / "A"
    cfg = Config.from_yaml(exp / "config.yaml")
    steps, spe = a["steps"], n_train // cfg.batch_size
    n_val = cfg.num_epochs * -(-n_test // 4)        # test batches of 4 per epoch
    n_img = steps // cfg.img_summary_freq
    expect = {"steps": cfg.num_epochs * spe, "student_forward": 3 * steps,
              "teacher_forward": 3 * steps, "backward": 3 * steps, "backward_smem": 3 * steps,
              "validation_forward": 3 * n_val, "image_forward": 3 * n_img, "fp32_forward": 0}
    got = {"steps": steps, "teacher_forward": a["teacher_launches"],
           "student_forward": (a["bf16_launches"] - a["teacher_launches"]
                               - a["validation_launches"] - a["image_launches"]),
           "backward": a["backward_launches"],
           "backward_smem": a["backward_path_launches"]["smem"],
           "validation_forward": a["validation_launches"], "image_forward": a["image_launches"],
           "fp32_forward": a["launches"] - a["bf16_launches"]}
    path_launches["trainer"] = a["launches"]
    path_launches["trainer_backward"] = a["backward_launches"]
    emit({"trainer_run_a_launches": got, "expected": expect})
    if got != expect:
        raise AssertionError(f"run A: launches {got}, expected {expect}")

    records = _train_records(exp)
    val = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()
           if "val/vimeo90k/val/vimeo90k_psnr" in line]
    psnr = [r["val/vimeo90k/val/vimeo90k_psnr"] for r in val]
    profiled = set(range(PROFILE_STEPS[0] + 1, PROFILE_STEPS[1] + 1))
    timed = [r for r in records if r["step"] > 3 and r["step"] not in profiled]
    step_ms = sorted(1e3 * r["train/train_time"] for r in timed)
    data = sum(r["train/data_time"] for r in timed)
    share = data / (data + sum(r["train/train_time"] for r in timed))
    profile = a["profile"]
    emit({"trainer_run_a": {
        "steps": steps, "seconds": round(a_seconds, 3),
        "ms_per_step_median": step_ms[len(step_ms) // 2], "ms_per_step_min": step_ms[0],
        "ms_per_step_max": step_ms[-1], "timed_steps": len(step_ms),
        "train_time_ms_by_step": [round(1e3 * r["train/train_time"], 3) for r in records],
        "data_time_ms_by_step": [round(1e3 * r["train/data_time"], 3) for r in records],
        "data_time_share": share, "peak_memory_bytes": a["peak_memory_bytes"],
        "val_psnr_per_epoch": psnr,
        "profile": {k: v for k, v in profile.items() if k != "top"},
        "top_device_ops": profile["top"][:10], "card": card}})
    if [r["step"] for r in records] != list(range(1, steps + 1)) or len(psnr) != 2:
        raise AssertionError(f"run A logged steps {[r['step'] for r in records]}, "
                             f"validations {psnr}")
    if not profile["busy_share"] or not 0 < profile["busy_share"] <= 1:
        raise AssertionError(f"run A's profile shows no device time: {profile}")

    # Its checkpoints: the four names, JAX's metadata (each save's step, its
    # epoch, the best PSNR so far), each restoring bit for bit.
    best = max(psnr)
    latest = steps - steps % cfg.save_latest_freq
    at_best = 1 + psnr.index(best)
    want_meta = {
        "latest": {"step": latest, "epoch": (latest - 1) // spe,
                   "best_psnr": max(psnr[:(latest - 1) // spe], default=0.0)},
        "epoch_001": {"step": spe, "epoch": 1, "best_psnr": 0.0},
        "epoch_002": {"step": 2 * spe, "epoch": 2, "best_psnr": psnr[0]},
        "best_vimeo90k": {"step": at_best * spe, "epoch": at_best, "best_psnr": best}}
    ckpts = CheckpointManager(exp, create=False)
    files = sorted(p.name for p in ckpts.dir.iterdir())
    meta, restored = {}, {}
    for name in filter(ckpts.exists, want_meta):
        tree, meta[name] = ckpts.restore(name)
        state = create_train_state(create_model(cfg, torch.float32), cfg)
        state_from_flax(tree, state)
        again, disk = _leaves(state_to_flax(state)), _leaves(tree)
        restored[name] = (again.keys() == disk.keys() and state.step == meta[name]["step"]
                          and all(np.array_equal(again[k], v) and again[k].dtype == v.dtype
                                  for k, v in disk.items()))
    images = sorted(p.name for p in (exp / "images").iterdir())
    emit({"trainer_checkpoints": files, "meta": meta, "restored_bit_for_bit": restored,
          "images": images, "config_yaml": (exp / "config.yaml").is_file()})
    if meta != want_meta or not all(restored.values()) or len(restored) != 4:
        raise AssertionError(f"run A checkpoints: {meta} (expected {want_meta}), "
                             f"restored {restored}")
    if images != [f"{k}_{s:07d}.png" for k in ("flow", "pred")
                  for s in range(cfg.img_summary_freq, steps + 1, cfg.img_summary_freq)]:
        raise AssertionError(f"run A images {images}")

    # evaluate --exp_name: the card in fp32, and the CPU (beside B and C).
    cpu_out, cpu_log = tmp / "eval_cpu.json", tmp / "eval_cpu.log"
    cpu = start_child("evaluate", cpu_out, ["--exp_name", "A", "--ssim", "--device", "cpu"],
                      tmp, cpu_log)
    deformable_sample.launches = deformable_sample.bf16_launches = 0
    with working_directory(tmp):
        on_card = evaluate.main(["--exp_name", "A", "--ssim", "--device", "cuda"])
    torch.cuda.synchronize()
    path_launches["evaluate_exp_name"] = deformable_sample.launches
    eval_launches = (deformable_sample.launches, deformable_sample.bf16_launches)

    # Runs B (preempted at step SIGTERM_AT_STEP, then resumed) and C (twice).
    bc = ["--set", f"teacher_ckpt={ROOT / TRAINER_TEACHER}", "--set", f"root={root}",
          "--config", str(ROOT / TRAINER_RECIPE), "--device", "cuda", *_sets(RUN_BC)]
    out, log = tmp / "run_b1.json", tmp / "run_b1.log"
    proc = start_child("train", out, ["--exp_name", "B", *bc], tmp, log)
    # C and C2 run beside B (nothing of theirs is timed).
    runs_c = [(start_child("train", tmp / f"run_{n}.json", ["--exp_name", n.upper(), *bc], tmp,
                           tmp / f"run_{n}.log"), tmp / f"run_{n}.json", tmp / f"run_{n}.log")
              for n in ("c", "c2")]
    metrics, signalled = tmp / "exps" / "B" / "metrics.jsonl", None
    deadline = time.perf_counter() + 600
    while proc.poll() is None and time.perf_counter() < deadline:
        if metrics.is_file() and any(r["step"] >= SIGTERM_AT_STEP
                                     for r in _train_records(metrics.parent)):
            proc.send_signal(signal.SIGTERM)
            signalled = max(r["step"] for r in _train_records(metrics.parent))
            break
        time.sleep(0.02)
    b1 = finish_child(proc, out, log, 600)
    b_meta = json.loads((tmp / "exps" / "B" / "checkpoints" / "latest.meta.json").read_text())
    b2 = run("train", "run_b2", ["--exp_name", "B", "--resume", "latest", *bc])
    c, c2 = (finish_child(*r, 600) for r in runs_c)
    final = {name: _param_leaves(tmp / "exps" / name / "checkpoints" / "epoch_001.ckpt")
             for name in ("B", "C", "C2")}
    norm = np.linalg.norm(final["C"])
    b_gap = float(np.linalg.norm(final["B"] - final["C"]) / norm)
    c_gap = float(np.linalg.norm(final["C2"] - final["C"]) / norm)
    b_steps = [r["step"] for r in _train_records(tmp / "exps" / "B")]
    emit({"trainer_preemption": {
        "sigterm_after_step": signalled, "latest_meta": b_meta, "first_run_steps": b1["steps"],
        "resumed_steps": b2["steps"], "logged_steps": b_steps,
        "final_rel_l2_B_vs_C": b_gap, "final_rel_l2_C2_vs_C": c_gap,
        "max_abs_B_vs_C": float(np.abs(final["B"] - final["C"]).max()),
        "max_abs_C2_vs_C": float(np.abs(final["C2"] - final["C"]).max()),
        "steps_c": [c["steps"], c2["steps"]]}})
    if not (signalled is not None and b1["steps"] == b_meta["step"] < spe
            and b_meta["epoch"] == 0 and b2["steps"] == c["steps"] == c2["steps"] == spe
            and b_steps == list(range(1, spe + 1))):
        raise AssertionError(f"preemption run: SIGTERM after step {signalled}, 'latest' "
                             f"{b_meta}, steps {b1['steps']} / {b2['steps']}, logged {b_steps}")
    if b_gap > 2 * c_gap:
        raise AssertionError(f"the resumed run is {b_gap} from the uninterrupted one, over "
                             f"twice the gap between two uninterrupted runs ({c_gap})")

    cpu_scores = finish_child(cpu, cpu_out, cpu_log, 900)["scores"]
    diffs = {k: on_card[k] - v for k, v in cpu_scores.items()}
    emit({"evaluate_exp_name": {"card": on_card, "cpu": cpu_scores, "card_minus_cpu": diffs,
                                "launches": eval_launches[0], "bf16_launches": eval_launches[1]}})
    if (on_card.keys() != cpu_scores.keys()
            or abs(diffs["val/vimeo90k_psnr"]) > EVAL_PSNR_TOL
            or abs(diffs["val/vimeo90k_ssim"]) > EVAL_SSIM_TOL):
        raise AssertionError(f"evaluate --exp_name: card {on_card} against CPU {cpu_scores}")
    if eval_launches != (3 * -(-n_test // 4), 0):
        raise AssertionError(f"evaluate --exp_name: {eval_launches} launches (all, bf16); "
                             f"expected {3 * -(-n_test // 4)} fp32")
    for r in (a, b1, b2, c, c2):
        launched.update(map(tuple, r["forward_shapes"]))
        launched_backward.update(map(tuple, r["backward_shapes"]))


def family_config(name: str, **overrides):
    """Family ``name``'s config: its YAML as it stands, plus the quality
    study's dilated taps and offset groups for the variant."""
    from videoframeinterpolation_tpu_torch.config import Config
    from videoframeinterpolation_tpu_torch.tools.head_to_head import OFFSET_GROUPS, OFFSET_SETS

    if name.endswith("_dilated_goff"):
        overrides = {"offset_sets": OFFSET_SETS, "n_offset_groups": OFFSET_GROUPS, **overrides}
    return Config.from_yaml(ROOT / FAMILIES[name], **overrides)


def seeded_family_state(name: str):
    """``(config, TrainState)`` of family ``name`` (:func:`seeded_state` of
    its config and ``FAMILY_SEED``)."""
    cfg = family_config(name)
    return cfg, seeded_state(cfg, FAMILY_SEED, FAMILY_KERNEL_GAIN.get(name, 1.0))


def seeded_state(cfg, seed: int, kernel_gain: float = 1.0):
    """The TrainState of ``cfg``'s model at full width on the CPU, fp32,
    with every parameter and moment drawn with numpy from ``seed`` in the
    order of the parameters' sorted names: kernels
    ``U(+-1/sqrt(fan_in))`` (the torch-default rule of ``nn/blocks.py``; the
    zero-initialised offset predictors too, so that offsets act) times
    ``kernel_gain``, biases
    ``N(0, 0.02)``, PReLU slopes ``0.25 + N(0, 0.02)``; the Swin layers'
    kernels and relative position bias tables ``N(0, 0.02)`` (the spread
    of their ``truncated_normal(0.02)`` init), LayerNorm scales ``1 +
    N(0, 0.02)``; ``mu`` ``N(0,
    1e-4)`` and ``nu`` ``U(1e-8, 1e-6)``, the moments of a run in progress,
    so that a gradient that is zero in exact arithmetic (the key
    projections' biases: the softmax ignores a shift shared by every tap)
    does not decide the sign of an update; the step and the counts
    ``FAMILY_STEP``."""
    from videoframeinterpolation_tpu_torch.models import create_model
    from videoframeinterpolation_tpu_torch.nn.blocks import _fan_in, trunc_normal_02
    from videoframeinterpolation_tpu_torch.train import create_train_state

    model = create_model(cfg, torch.float32)
    modules = dict(model.named_modules())
    state = create_train_state(model, cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, p in sorted(model.named_parameters()):
            owner, _, leaf = key.rpartition(".")
            if leaf == "alpha":
                value = 0.25 + rng.normal(0, 0.02, p.shape)
            elif leaf == "scale":
                value = 1.0 + rng.normal(0, 0.02, p.shape)
            elif leaf in ("bias", "relative_position_bias_table") or (
                    getattr(modules[owner], "kernel_init", None) is trunc_normal_02):
                value = rng.normal(0, 0.02, p.shape)
            else:
                bound = 1.0 / np.sqrt(_fan_in(modules[owner]))
                value = rng.uniform(-bound, bound, p.shape) * kernel_gain
            p.copy_(torch.from_numpy(value.astype(np.float32)))
            state.opt_state.exp_avg[key].copy_(
                torch.from_numpy(rng.normal(0, 1e-4, p.shape).astype(np.float32)))
            state.opt_state.exp_avg_sq[key].copy_(
                torch.from_numpy(rng.uniform(1e-8, 1e-6, p.shape).astype(np.float32)))
    state.step = state.opt_state.count = state.opt_state.schedule_count = FAMILY_STEP
    return state


def frame_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR (dB) of a ``[0, 1]`` float frame against a uint8 frame, in float64."""
    mse = np.mean((pred.astype(np.float64) - gt.astype(np.float64) / 255.0) ** 2)
    return float(10 * np.log10(1.0 / mse))


def family_yaml(tmp: Path, name: str, cfg) -> Path:
    """A YAML file of family ``name``'s config: its own, or for the variant
    the config written under ``tmp``, as a user would write one."""
    if not name.endswith("_dilated_goff"):
        return ROOT / FAMILIES[name]
    path = tmp / f"{name}.yaml"
    cfg.save_yaml(path)
    return path


def check_families(tmp: Path, card: str, path_launches: dict, launched: set,
                   launched_backward: set) -> None:
    """Phase 15 (see the module docstring)."""
    ckpts = tmp / "families"
    ckpts.mkdir()
    for name in FAMILIES:
        serve_family(ckpts, name, card, path_launches)
    for name in FAMILIES:
        counts = family_step_card_vs_cpu(ckpts / f"{name}.ckpt", name)
        per_step = FAMILY_LAUNCHES[name]
        if (counts["forward"], counts["backward"]) != (per_step, per_step):
            raise AssertionError(f"{name}: the fp32 step on the card launched {counts}; "
                                 f"expected {per_step} forward and {per_step} backward")
        if per_step:
            path_launches[f"families_step_{name}"] = counts["forward"]
            path_launches[f"families_step_{name}_backward"] = counts["backward"]
    train_families(tmp, card, path_launches, launched, launched_backward)
    family_head_to_head(tmp, card, path_launches)


def serve_family(ckpts: Path, name: str, card: str, path_launches: dict) -> None:
    """Phase 15 (a) for one family: :func:`serve_seeded` of its seeded
    TrainState from its YAML (the variant's written under ``ckpts``), with
    ``FAMILY_LAUNCHES`` sampler launches per request, against
    ``JAX_FAMILIES``."""
    from videoframeinterpolation_tpu_torch.train import state_to_flax

    cfg, state = seeded_family_state(name)
    serve_seeded(name, family_yaml(ckpts, name, cfg), state_to_flax(state),
                 ckpts / f"{name}.ckpt", card, path_launches, f"families_{name}",
                 JAX_FAMILIES[name], launches=FAMILY_LAUNCHES[name])


def serve_seeded(name: str, yaml: Path, tree, ckpt: Path, card: str, path_launches: dict,
                 path_key: str, reference: tuple, launches: int, strided: int = 0) -> None:
    """Phases 15 (a) and 16 (b) for one model: its TrainState ``tree``
    written by the port's writer to ``ckpt`` and served through
    ``load_model`` from ``yaml`` in the YAML's bf16: four 448x256 requests
    through ``interp_pair`` (:func:`serve_requests_counted`, ``launches``
    sampler launches each, ``strided`` of them strided), their launches put
    in ``path_launches`` under ``path_key``; one request card against CPU
    (``card_vs_cpu``); the fp32 frame against the JAX package's CPU read
    ``reference`` (:func:`hold_fp32_frame`); ms per frame in bf16 and fp32,
    and ``tools/profile_serve.py``'s device operations and busy share."""
    from videoframeinterpolation_tpu_torch.config import Config
    from videoframeinterpolation_tpu_torch.interpolate import load_model
    from videoframeinterpolation_tpu_torch.tools import profile_serve
    from videoframeinterpolation_tpu_torch.train import write_flax_state

    write_flax_state(ckpt, tree)
    cfg = Config.from_yaml(yaml)
    model = load_model(cfg, ckpt, device="cuda")
    if model.dtype != torch.bfloat16 or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{name} served in {model.dtype}, its YAML says {cfg.compute_dtype}")
    served = serve_requests_counted(model, name, launches, strided)
    path_launches[path_key] = launches * len(served)
    if strided:
        path_launches[f"{path_key}_strided"] = strided * len(served)
    emit({"model": name, "yaml": yaml.name, "params": sum(p.numel() for p in model.parameters()),
          "dtype": str(model.dtype), "requests": served, "launches_per_request": launches,
          "strided_launches_per_request": strided})
    _, _, _, x0, x1, t5 = scene_inputs()
    model32 = card_vs_cpu(cfg, ckpt, model, x0, x1, t5)
    hold_fp32_frame(model32, name, reference, card, model)
    del model, model32
    torch.cuda.empty_cache()
    summary = profile_serve.main(["--config", str(yaml), "--ckpt", str(ckpt), "--requests", "5"])
    emit({"model": name, "profile_serve": {k: v for k, v in summary.items() if k != "top"},
          "top_device_ops": summary["top"][:8]})
    if not summary["device_busy_ms_per_request"] > 0:
        raise AssertionError(f"{name}: the profile shows no device time: {summary}")
    if summary["dcn_calls_per_request"] and not summary["dcn_ms_per_request"] > 0:
        raise AssertionError(f"{name}: the profile gives the deformable convolution's "
                             f"{summary['dcn_calls_per_request']} calls no device time")
    if summary["swin_calls_per_request"] and not summary["swin_ms_per_request"] > 0:
        raise AssertionError(f"{name}: the profile gives the Swin decoders' "
                             f"{summary['swin_calls_per_request']} calls no device time")


def family_step_card_vs_cpu(ckpt: Path, name: str) -> dict:
    """Phase 15 (b), first part: :func:`step_card_vs_cpu` from the family's
    seeded TrainState (with the launches it returns)."""
    from videoframeinterpolation_tpu_torch.train import read_flax_state

    return step_card_vs_cpu(family_config(name, compute_dtype="float32"),
                            read_flax_state(ckpt), name)


def step_card_vs_cpu(cfg32, tree, name: str) -> dict:
    """One fp32 training step (the model's own recipe, ``make_loss_fn``) of
    ``cfg32``'s model from the TrainState ``tree``, TF32 off, batch 2 at
    128x128 of the held-out pool's training split, on the card against the
    same step on the CPU, to phase 10 (a)'s limits. Returns the card's
    sampler launches (forward, backward and their strided parts)."""
    from videoframeinterpolation_tpu_torch.models import create_model
    from videoframeinterpolation_tpu_torch.tools.eval_best import build_pool
    from videoframeinterpolation_tpu_torch.train import (
        create_train_state, make_loss_fn, state_from_flax, state_to_flax)

    batch_np = build_pool(2, (128, 128), 42, is_train=True)
    launches = {}
    step = {}
    for device in ("cuda", "cpu"):
        torch.set_num_threads((os.cpu_count() or 1) if device == "cpu" else 1)
        state = create_train_state(create_model(cfg32, torch.float32).to(device), cfg32)
        state_from_flax(tree, state)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        reset_sampler_counts()
        start = time.perf_counter()
        total, _ = make_loss_fn(state.model, cfg32)(batch)
        total.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone()
                 for k, p in state.params.items()}
        state.apply_gradients()
        if device == "cuda":
            torch.cuda.synchronize()
            if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("TF32 is on: the fp32 step would not compute fp32")
            launches = sampler_counts()
        step[device] = {"loss": total.item(), "grads": grads,
                        "tree": _leaves(state_to_flax(state)),
                        "seconds": time.perf_counter() - start}
        del state, batch, total
    torch.set_num_threads(1)
    on_card, cpu = step["cuda"], step["cpu"]
    loss_err = abs(on_card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    keys = sorted(cpu["grads"])
    grad_err = (torch.cat([(on_card["grads"][k] - cpu["grads"][k]).flatten() for k in keys]).norm()
                / torch.cat([cpu["grads"][k].flatten() for k in keys]).norm()).item()
    state_err = {part: float(max(np.abs(on_card["tree"][k] - v).max()
                                 for k, v in cpu["tree"].items() if k.startswith(part)))
                 for part in ("params/", "opt_state/0/mu/", "opt_state/0/nu/")}
    emit({"model": name, "train_step_fp32_card_vs_cpu": {
        "loss_card": on_card["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_err,
        "grad_rel_l2_err": grad_err, "state_max_abs_err": state_err, "launches": launches,
        "card_seconds": on_card["seconds"], "cpu_seconds": cpu["seconds"]}})
    if not (loss_err <= STEP_LOSS_REL_TOL and grad_err <= STEP_GRAD_TOL
            and max(state_err.values()) <= STEP_STATE_TOL):
        raise AssertionError(f"{name}: fp32 step, card vs CPU: loss {loss_err}, gradients "
                             f"{grad_err}, state {state_err}")
    return launches


def _write_forward_flows(args):
    """One training sequence's forward flows (run in a worker process)."""
    from videoframeinterpolation_tpu_torch.tools import fixtures

    fixtures.write_vimeo90k_forward_flows(*args)


def train_families(tmp: Path, card: str, path_launches: dict, launched: set,
                   launched_backward: set) -> None:
    """Phase 15 (b), second part: the production trainer's CLI with each
    YAML at its recipe on phase 14's tree (``FAMILY_TRAIN_SEQUENCES``; for
    IFRNet a root beside it listing its first 48 sequences, with their
    forward flows written under the YAML's ``flow_dir``; for DCNTrans one
    listing its first 64), for one epoch of 8
    steps with ``RUN_FAMILY``'s cadences (and ``FAMILY_TRAIN_SETS``),
    ``FAMILY_PROFILE_STEPS`` traced; ms per step, the ``data_time`` share,
    peak memory, the busy share; ``FAMILY_LAUNCHES`` sampler launches per
    training step, backward step, validation batch and image summary, all
    in bf16; ``latest``, ``epoch_001`` and ``best_vimeo90k`` restore
    bit for bit; then ``evaluate --exp_name`` on the card in fp32 within
    0.005 dB and 5e-5 SSIM of the same on the CPU."""
    from videoframeinterpolation_tpu_torch import evaluate
    from videoframeinterpolation_tpu_torch.config import Config
    from videoframeinterpolation_tpu_torch.models import create_model
    from videoframeinterpolation_tpu_torch.tools import fixtures
    from videoframeinterpolation_tpu_torch.train import (CheckpointManager, create_train_state,
                                                         state_from_flax, state_to_flax)

    tree = tmp / "datasets" / "vimeo_triplet"
    hw, seed = TRAINER_TREE["hw"], TRAINER_TREE["seed"]
    ifrnet = tmp / "datasets" / "vimeo_ifrnet"
    if "IFRNet" in FAMILY_TRAIN_SEQUENCES:
        ifrnet.mkdir()
        flow_dir = Config.from_yaml(ROOT / FAMILIES["IFRNet"]).flow_dir
        n_ifrnet = FAMILY_TRAIN_SEQUENCES["IFRNet"]
        start = time.perf_counter()
        list(render_pool().map(_write_forward_flows,
                               [(ifrnet, i, hw, seed, flow_dir) for i in range(n_ifrnet)]))
        (ifrnet / "sequences").symlink_to(tree / "sequences")
        (ifrnet / "tri_testlist.txt").write_text((tree / "tri_testlist.txt").read_text())
        fixtures.write_vimeo90k_trainlist(ifrnet, n_ifrnet)
        emit({"family_forward_flows": {"sequences": n_ifrnet, "flow_dir": flow_dir,
                                       "seconds": round(time.perf_counter() - start, 3)}})

    def run(kind, name, argv, timeout=600):
        out, log = tmp / f"{name}.json", tmp / f"{name}.log"
        return finish_child(start_child(kind, out, argv, tmp, log), out, log, timeout)

    n_test = TRAINER_TREE["test"]
    roots = {name: ifrnet if name == "IFRNet" else tree for name in FAMILY_TRAIN_SEQUENCES}
    for name, n in FAMILY_TRAIN_SEQUENCES.items():
        if name != "IFRNet" and n < TRAINER_TREE["train"]:
            # A root beside the tree that lists its first n sequences.
            roots[name] = tmp / "datasets" / f"vimeo_{name}"
            roots[name].mkdir()
            for part in ("sequences", "flow"):
                (roots[name] / part).symlink_to(tree / part)
            (roots[name] / "tri_testlist.txt").write_text(
                (tree / "tri_testlist.txt").read_text())
            fixtures.write_vimeo90k_trainlist(roots[name], n)
    for name, root in roots.items():
        exp_name = f"family_{name}"
        torch.cuda.empty_cache()
        start = time.perf_counter()
        r = run("train", exp_name, ["--exp_name", exp_name, "--config", str(ROOT / FAMILIES[name]),
                                    "--set", f"root={root}", "--device", "cuda",
                                    *_sets(RUN_FAMILY + FAMILY_TRAIN_SETS.get(name, [])),
                                    "--profile_steps", ",".join(map(str, FAMILY_PROFILE_STEPS))])
        seconds = time.perf_counter() - start
        exp = tmp / "exps" / exp_name
        cfg = Config.from_yaml(exp / "config.yaml")
        spe = FAMILY_TRAIN_SEQUENCES[name] // cfg.batch_size
        records = _train_records(exp)
        profiled = set(range(FAMILY_PROFILE_STEPS[0] + 1, FAMILY_PROFILE_STEPS[1] + 1))
        timed = [x for x in records if x["step"] > 3 and x["step"] not in profiled]
        step_ms = sorted(1e3 * x["train/train_time"] for x in timed)
        data = sum(x["train/data_time"] for x in timed)
        val = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()
               if "val/vimeo90k/val/vimeo90k_psnr" in line]
        path_launches[f"families_trainer_{name}"] = r["launches"]
        per_step = FAMILY_LAUNCHES[name]
        if per_step:
            path_launches[f"families_trainer_{name}_backward"] = r["backward_launches"]
        n_val = cfg.num_epochs * -(-n_test // 4)        # test batches of 4 per epoch
        expect = {"training_forward": per_step * spe, "backward": per_step * spe,
                  "validation_forward": per_step * n_val,
                  "image_forward": per_step * (spe // cfg.img_summary_freq), "fp32_forward": 0}
        got = {"training_forward": (r["launches"] - r["validation_launches"]
                                    - r["image_launches"]),
               "backward": r["backward_launches"], "validation_forward": r["validation_launches"],
               "image_forward": r["image_launches"],
               "fp32_forward": r["launches"] - r["bf16_launches"]}
        emit({"family_trainer": {
            "family": name, "model": cfg.model_name, "batch_size": cfg.batch_size,
            "crop": [cfg.crop_h, cfg.crop_w], "dtype": cfg.compute_dtype, "steps": r["steps"],
            "seconds": round(seconds, 3), "ms_per_step_median": step_ms[len(step_ms) // 2],
            "ms_per_step_min": step_ms[0], "ms_per_step_max": step_ms[-1],
            "timed_steps": len(step_ms),
            "train_time_ms_by_step": [round(1e3 * x["train/train_time"], 3) for x in records],
            "data_time_share": data / (data + sum(x["train/train_time"] for x in timed)),
            "peak_memory_bytes": r["peak_memory_bytes"],
            "val_psnr": [x["val/vimeo90k/val/vimeo90k_psnr"] for x in val],
            "sampler_launches": r["launches"], "sampler_backward_launches": r["backward_launches"],
            "sampler_launches_by_kind": got,
            "sampler_backward_by_path": r["backward_path_launches"],
            "profile": {k: v for k, v in r["profile"].items() if k != "top"},
            "top_device_ops": r["profile"]["top"][:10], "card": card}})
        if (r["steps"] != spe or spe != 8 or [x["step"] for x in records] != list(range(1, 9))
                or len(val) != 1 or got != expect):
            raise AssertionError(f"{name}: {r['steps']} steps, logged "
                                 f"{[x['step'] for x in records]}, validations {len(val)}, "
                                 f"sampler launches {got}, expected {expect}")
        if not r["profile"]["busy_share"] or not 0 < r["profile"]["busy_share"] <= 1:
            raise AssertionError(f"{name}: the profile shows no device time: {r['profile']}")
        ckpts = CheckpointManager(exp, create=False)
        restored = {}
        for ck in ("latest", "epoch_001", f"best_{cfg.save_best_benchmark}"):
            saved, meta = ckpts.restore(ck)
            state = create_train_state(create_model(cfg, torch.float32), cfg)
            state_from_flax(saved, state)
            again, disk = _leaves(state_to_flax(state)), _leaves(saved)
            restored[ck] = (again.keys() == disk.keys() and state.step == meta["step"] == 8
                            and all(np.array_equal(again[k], v) and again[k].dtype == v.dtype
                                    for k, v in disk.items()))
        emit({"family": name, "checkpoints_restored_bit_for_bit": restored})
        if not all(restored.values()):
            raise AssertionError(f"{name}: checkpoints restored {restored}")
        launched.update(map(tuple, r["forward_shapes"]))
        launched_backward.update(map(tuple, r["backward_shapes"]))

    # evaluate --exp_name: the CPU runs in children beside the card's.
    cpu = {}
    for name in roots:
        out, log = tmp / f"family_eval_cpu_{name}.json", tmp / f"family_eval_cpu_{name}.log"
        cpu[name] = (start_child("evaluate", out, ["--exp_name", f"family_{name}", "--ssim",
                                                   "--device", "cpu"], tmp, log), out, log)
    for name in roots:
        start = time.perf_counter()
        with working_directory(tmp):
            on_card = evaluate.main(["--exp_name", f"family_{name}", "--ssim", "--device",
                                     "cuda"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - start
        cpu_scores = finish_child(*cpu[name], 900)["scores"]
        diffs = {k: on_card[k] - v for k, v in cpu_scores.items()}
        emit({"family": name, "evaluate_exp_name": {
            "card": on_card, "cpu": cpu_scores, "card_minus_cpu": diffs, "items": n_test,
            "card_seconds": round(card_s, 3)}})
        if (on_card.keys() != cpu_scores.keys()
                or abs(diffs["val/vimeo90k_psnr"]) > EVAL_PSNR_TOL
                or abs(diffs["val/vimeo90k_ssim"]) > EVAL_SSIM_TOL):
            raise AssertionError(f"{name}: evaluate --exp_name, card {on_card} against CPU "
                                 f"{cpu_scores}")


def family_head_to_head(tmp: Path, card: str, path_launches: dict) -> None:
    """Phase 15 (c): ``tools/head_to_head.py`` on the dilated + group-offset
    DAT-TPU for 20 steps on a 64-scene pool: its records under JAX's tag,
    ms per step, no sampler launch."""
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.tools import head_to_head

    out_dir = tmp / "families_h2h"
    deformable_sample.launches = deformable_sample.backward_launches = 0
    out = head_to_head.main(FAMILY_H2H + ["--out_dir", str(out_dir), "--device", "cuda"])
    path_launches["families_head_to_head"] = deformable_sample.launches
    records = out["records"]
    emit({"family_head_to_head": {
        "tag": out["tag"], "events": [r["event"] for r in records], "final": records[-1],
        "n_params": records[0].get("n_params"), "ms_per_step": out["ms_per_step"],
        "peak_memory_bytes": out["peak_memory_bytes"], "files": sorted(
            p.name for p in out_dir.iterdir()), "sampler_launches": deformable_sample.launches,
        "card": card}})
    if (out["tag"] != FAMILY_H2H_TAG or [r["event"] for r in records] != ["start", "eval", "final"]
            or not (out_dir / f"{FAMILY_H2H_TAG}.jsonl").is_file()
            or records[0]["n_params"] != 4_567_055 or out["state"].step != 20
            or deformable_sample.launches or deformable_sample.backward_launches):
        raise AssertionError(f"head_to_head on the variant: tag {out['tag']}, records {records}, "
                             f"sampler launches {deformable_sample.launches}")


def check_variants(tmp: Path, gen, card: str, path_launches: dict, scenes: dict,
                   student_synthetic: dict) -> dict:
    """Phase 16 (see the module docstring). Returns the strided level shapes
    it held (forward and backward, for phase 13), its worst errors and the
    launches of the stride arm's paths."""
    out = check_strided_sampler(gen)
    trees = {}
    for name in VARIANTS:
        trees[name] = serve_variant(tmp, name, card, path_launches)
    check_window_and_ref_units(tmp, card, path_launches, scenes, student_synthetic)
    out["train"] = train_variants(tmp, card, path_launches, trees["stride_arm"])
    out["serve_strided_launches"] = path_launches["variants_serve_stride_arm_strided"]
    return out


def check_strided_sampler(gen) -> dict:
    """Phase 16 (a): the sampler and its backward on the query grid of
    stride 2 at ``STRIDED_CASES``, held as phases 2 and 13 hold theirs (the
    forward exact in fp32 and 0 bf16 ulps from the fp32 sampling rounded
    once, at every vector and index width; the backward to phase 2's limits
    on its planned path and the global path forced, its coordinate
    gradients equal over two launches). Phase 5 times them."""
    from videoframeinterpolation_tpu_torch.tools.perf import sampler_probe

    reached, reached_bwd, worst, bwd_err = set(), set(), 0.0, (0.0, 0.0)
    for name, (B2, h, w, C, G, S, scale, flow_mag) in STRIDED_CASES.items():
        inputs = sampler_probe.level_inputs(gen, B2, h, w, C, G, S, scale, flow_mag, stride=2)
        worst = max(worst, check_sampler_case(f"strided_{name}", *inputs, 0, reached, 2))
        del inputs
        errs = check_backward_case(gen, f"strided_{name}", STRIDED_CASES[name], reached_bwd, 2)
        bwd_err = (max(bwd_err[0], errs[0]), max(bwd_err[1], errs[1]))
    need = ({("torch.float32", v, b) for v in (16, 8, 4) for b in (32, 64)}
            | {("torch.bfloat16", v, b) for v in (16, 8, 4, 2) for b in (32, 64)})
    need_bwd = {(path, dt, v, b) for path in ("smem", "global") for b in (32, 64)
                for dt, widths in (("torch.float32", (16, 8, 4)),
                                   ("torch.bfloat16", (16, 8, 4, 2))) for v in widths}
    if need - reached or need_bwd - reached_bwd:
        raise AssertionError(f"strided instances never run: {sorted(need - reached, key=str)}, "
                             f"backward {sorted(need_bwd - reached_bwd, key=str)}")
    emit({"strided_sampler_checked": {"forward_instances": len(need),
                                      "backward_instances": len(need_bwd),
                                      "max_abs_err": worst, "backward_fp32_max_abs_err": bwd_err[0],
                                      "backward_fp32_err_over_max_abs": bwd_err[1]}})
    torch.cuda.empty_cache()
    shapes = {(B2, h, w, C, G, S, 2) for B2, h, w, C, G, S, *_ in STRIDED_CASES.values()}
    return {"forward_held": shapes, "backward_held": shapes, "max_abs_err": worst,
            "backward_err": bwd_err}


def variant_config(name: str, **overrides):
    """Arm ``name``'s config: ``configs/DAT_fast.yaml`` with the arm's fields."""
    from videoframeinterpolation_tpu_torch.config import Config

    return Config.from_yaml(ROOT / "configs" / "DAT_fast.yaml", **VARIANTS[name], **overrides)


def scene_inputs():
    """``FAMILY_SCENE``'s frames (uint8), its true middle frame, and the
    fp32 model inputs of the pair at t = 0.5 on the CPU."""
    from videoframeinterpolation_tpu_torch.tools import fixtures

    f0, mid, f1 = fixtures.triplet(*FAMILY_SCENE)
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None] for f in (f0, f1))
    return f0, mid, f1, x0, x1, torch.full((1, 1, 1, 1), 0.5)


def hold_fp32_frame(model32, name: str, reference: tuple, card: str, model=None) -> None:
    """The fp32 frame of ``model32`` on ``FAMILY_SCENE`` against the JAX
    package's CPU read ``reference`` (PSNR against the true middle frame,
    the frame's mean), within 0.005 dB and 1e-4; ms per frame of it and of
    ``model`` (the bf16 one), if given."""
    from videoframeinterpolation_tpu_torch.tools.perf import timing

    _, mid, _, x0, x1, t5 = scene_inputs()
    xs = (x0.cuda(), x1.cuda(), t5.cuda())
    torch.set_num_threads(1)
    with torch.inference_mode():
        frame = model32(*xs)[0].cpu().numpy()
        ms = {f"ms_per_frame_448x256_{k}": timing.loop_ms(lambda: m(*xs), 20, warmup=5) / 20
              for k, m in (("bf16", model), ("fp32", model32)) if m is not None}
    read = {"psnr": frame_psnr(frame, mid), "mean": float(frame.mean(dtype=np.float64))}
    ref_psnr, ref_mean = reference
    emit({"model": name, "fp32_frame": read, "jax_cpu_fp32": {"psnr": ref_psnr, "mean": ref_mean},
          "psnr_minus_jax_cpu": read["psnr"] - ref_psnr, "mean_minus_jax_cpu": read["mean"] - ref_mean,
          **ms, "card": card})
    if not (abs(read["psnr"] - ref_psnr) <= EVAL_PSNR_TOL
            and abs(read["mean"] - ref_mean) <= FAMILY_MEAN_TOL):
        raise AssertionError(f"{name}: fp32 frame {read} against JAX's CPU read "
                             f"{(ref_psnr, ref_mean)}")


def serve_requests_counted(model, name: str, launches: int, strided: int = 0) -> list:
    """Four requests on ``FAMILY_SCENE`` through ``interp_pair`` in bf16,
    each with exactly ``launches`` bf16 sampler launches, ``strided`` of
    them on a strided grid, and no backward launch."""
    from videoframeinterpolation_tpu_torch.interpolate import interp_pair

    f0, mid, f1, *_ = scene_inputs()
    served = []
    for t in (0.5, 0.25, 0.5, 0.75):
        reset_sampler_counts()
        start = time.perf_counter()
        pred = interp_pair(model, f0, f1, t)
        torch.cuda.synchronize()
        counts = sampler_counts()
        served.append({"t": t, "host_ms": round((time.perf_counter() - start) * 1e3, 3),
                       "psnr_vs_mid": round(psnr(pred, mid), 3), "launches": counts["forward"],
                       "strided_launches": counts["strided_forward"]})
        if pred.shape != mid.shape or pred.dtype != np.uint8:
            raise AssertionError(f"{name}: got {pred.dtype} {pred.shape}")
        got = tuple(counts[k] for k in ("forward", "bf16_forward", "strided_forward", "backward"))
        if got != (launches, launches, strided, 0):
            raise AssertionError(f"{name} request: launches {counts}; expected {launches} in "
                                 f"bf16, {strided} strided, no backward")
    return served


def serve_variant(tmp: Path, name: str, card: str, path_launches: dict):
    """Phase 16 (b) for one arm: :func:`serve_seeded` of its TrainState
    drawn from ``VARIANT_SEED``, its config written as a YAML, 3 launches per
    request (lv1's strided for the stride arm), against ``JAX_VARIANTS``.
    Returns the TrainState's flax tree."""
    from videoframeinterpolation_tpu_torch.train import state_to_flax

    cfg = variant_config(name)
    tree = state_to_flax(seeded_state(cfg, VARIANT_SEED))
    yaml = tmp / f"{name}.yaml"
    cfg.save_yaml(yaml)
    serve_seeded(name, yaml, tree, tmp / f"{name}.ckpt", card, path_launches,
                 f"variants_serve_{name}", JAX_VARIANTS[name], launches=3,
                 strided=int(cfg.dat_attn_stride[2] > 1))
    return tree


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms only, for two runs to be held equal
    bit for bit: by default cuDNN picks an algorithm per call, and two fp32
    evaluations of one checkpoint in one process can differ in the last
    bits (1e-7 dB over 64 scenes, NVIDIA H100 80GB HBM3)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def check_window_and_ref_units(tmp: Path, card: str, path_launches: dict, scenes: dict,
                               student_synthetic: dict) -> None:
    """Phase 16 (c): ``evaluate --benchmark synthetic --ssim`` on the shipped
    student with and without ``--window_sampling``, on phase 11's scenes,
    the two scores equal bit for bit (the same kernel; both runs with
    cuDNN's deterministic algorithms) and each within 0.005 dB and 5e-5
    SSIM of phase 11's; ``interpolate`` on a 448x256 PNG pair with and
    without the flag, the frames equal byte for byte; the committed ``DAT``
    checkpoint served with ``dat_ref_offset_units`` (four requests, 3
    launches each), card against CPU, and its fp32 frame against the JAX
    package's CPU read with the same flag."""
    from videoframeinterpolation_tpu_torch import evaluate, interpolate
    from videoframeinterpolation_tpu_torch.config import PRESETS
    from videoframeinterpolation_tpu_torch.data import encode_png

    scores, launches = {}, {}
    with cached_scenes(scenes), cudnn_deterministic():
        for flag in ((), ("--window_sampling",)):
            reset_sampler_counts()
            scores[flag] = evaluate.main(["--config", "DAT_fast", "--benchmark", "synthetic",
                                          "--ssim", *flag, "--device", "cuda"])
            torch.cuda.synchronize()
            launches[flag] = (sampler_counts()["forward"], sampler_counts()["bf16_forward"])
    flagged = scores[("--window_sampling",)]
    path_launches["variants_evaluate_window_sampling"] = launches[("--window_sampling",)][0]
    diffs = {k: flagged[k] - v for k, v in student_synthetic.items()}
    emit({"evaluate_window_sampling": flagged, "unflagged": scores[()],
          "equal_to_unflagged": flagged == scores[()], "phase_11": student_synthetic,
          "minus_phase_11": diffs, "launches": launches[("--window_sampling",)][0]})
    if (flagged != scores[()] or set(launches.values()) != {(48, 0)}
            or abs(diffs["val/synthetic_psnr"]) > EVAL_PSNR_TOL
            or abs(diffs["val/synthetic_ssim"]) > EVAL_SSIM_TOL):
        raise AssertionError(f"evaluate --window_sampling: {flagged} against {scores[()]} "
                             f"unflagged and phase 11's {student_synthetic}, launches "
                             f"{launches}; expected equal and 48 fp32 launches each")

    f0, _, f1, x0, x1, t5 = scene_inputs()
    for n, img in (("f0.png", f0), ("f1.png", f1)):
        (tmp / n).write_bytes(encode_png(img))
    outs = {}
    with cudnn_deterministic():
        for flag in ((), ("--window_sampling",)):
            out = tmp / f"mid{len(outs)}.png"
            reset_sampler_counts()
            interpolate.main(["--frame0", str(tmp / "f0.png"), "--frame1", str(tmp / "f1.png"),
                              "--out", str(out), *flag, "--device", "cuda"])
            torch.cuda.synchronize()
            outs[flag] = (out.read_bytes(), sampler_counts()["bf16_forward"])
    path_launches["variants_interpolate_window_sampling"] = outs[("--window_sampling",)][1]
    same = outs[()][0] == outs[("--window_sampling",)][0]
    emit({"interpolate_window_sampling": {"equal_to_unflagged": same,
                                          "bf16_launches": [v[1] for v in outs.values()]}})
    if not same or [v[1] for v in outs.values()] != [3, 3]:
        raise AssertionError(f"interpolate --window_sampling: equal {same}, launches "
                             f"{[v[1] for v in outs.values()]}")

    from videoframeinterpolation_tpu_torch.interpolate import load_model

    cfg, ckpt = PRESETS["DAT"]
    cfg = dataclasses.replace(cfg, dat_ref_offset_units=True)
    model = load_model(cfg, ckpt, device="cuda")
    served = serve_requests_counted(model, "DAT_ref_offset_units", 3)
    path_launches["variants_serve_ref_offset_units"] = 3 * len(served)
    emit({"model": "DAT_ref_offset_units", "checkpoint": str(ckpt.relative_to(ROOT)),
          "requests": served})
    model32 = card_vs_cpu(cfg, ckpt, model, x0, x1, t5)
    hold_fp32_frame(model32, "DAT_ref_offset_units", JAX_VARIANTS["DAT_ref_offset_units"], card)
    del model, model32
    torch.cuda.empty_cache()


def train_variants(tmp: Path, card: str, path_launches: dict, stride_tree) -> dict:
    """Phase 16 (d): one fp32 step of the stride arm from its seeded state,
    card against CPU to phase 10 (a)'s limits (3 forward and 3 backward
    launches, lv1's strided); ``tools/head_to_head.py`` on each arm for 20
    steps on a 64-scene pool (``VARIANT_H2H``): its records under JAX's tag,
    the record's n_params, ms per step, peak memory, and per step 3 bf16
    forward and 3 backward launches (the stride arm's lv1 strided both
    ways), 12 fp32 launches per held-out evaluation. Returns the launches
    of the stride arm's run."""
    from videoframeinterpolation_tpu_torch.tools import head_to_head

    launches = step_card_vs_cpu(variant_config("stride_arm", compute_dtype="float32"),
                                stride_tree, "stride_arm")
    path_launches["variants_train_step_fp32"] = launches["forward"]
    path_launches["variants_train_step_fp32_backward"] = launches["backward"]
    if [launches[k] for k in ("forward", "strided_forward", "backward", "strided_backward")] \
            != [3, 1, 3, 1]:
        raise AssertionError(f"stride arm's fp32 step: launches {launches}; expected 3 forward "
                             "and 3 backward, one of each strided")
    runs = {}
    for name, (flags, tag, n_params) in VARIANT_H2H_ARMS.items():
        reset_sampler_counts()
        out = head_to_head.main(VARIANT_H2H + flags + ["--out_dir", str(tmp / "h2h"),
                                                       "--device", "cuda"])
        torch.cuda.synchronize()
        counts = sampler_counts()
        records = out["records"]
        steps = out["state"].step
        strided = int(name == "stride_arm")
        expect = {"bf16_forward": 3 * steps, "fp32_forward": 2 * 12, "backward": 3 * steps,
                  "backward_smem": 3 * steps, "strided_forward": strided * (steps + 2 * 4),
                  "strided_backward": strided * steps}
        got = {"bf16_forward": counts["bf16_forward"],
               "fp32_forward": counts["forward"] - counts["bf16_forward"],
               "backward": counts["backward"], "backward_smem": counts["backward_by_path"]["smem"],
               "strided_forward": counts["strided_forward"],
               "strided_backward": counts["strided_backward"]}
        path_launches[f"variants_head_to_head_{name}"] = counts["forward"]
        path_launches[f"variants_head_to_head_{name}_backward"] = counts["backward"]
        runs[name] = counts
        emit({"variant_head_to_head": {
            "arm": name, "tag": out["tag"], "events": [r["event"] for r in records],
            "final": records[-1], "n_params": records[0].get("n_params"), "steps": steps,
            "ms_per_step": out["ms_per_step"], "peak_memory_bytes": out["peak_memory_bytes"],
            "launches": got, "expected": expect, "card": card}})
        if (out["tag"] != tag or [r["event"] for r in records] != ["start", "eval", "final"]
                or not (tmp / "h2h" / f"{tag}.jsonl").is_file() or steps != 20
                or records[0]["n_params"] != n_params or got != expect):
            raise AssertionError(f"head_to_head on the {name}: tag {out['tag']}, records "
                                 f"{records}, launches {got} against {expect}")
    return runs["stride_arm"]


def check_row_gather(gen, probe_shapes) -> None:
    """The row gather at the probes' shapes (K = M + 5) and ``ROW_CASES``,
    through the wrapper and then on the same inputs at both index widths;
    and ``ROW_WIDE`` on the wrapper's 64-bit indices. Each result must
    equal the plain version exactly (``torch.equal``); raises if any
    (dtype, index width) instance never ran."""
    from videoframeinterpolation_tpu_torch.kernels import row_gather, row_gather_plain
    from videoframeinterpolation_tpu_torch.kernels.gather import (
        _row_gather_launch, _row_index_bits)

    cases = {f"probe_{M}": (M, N, M + 5, dtype, 0) for M, N, dtype in probe_shapes}
    cases.update(ROW_CASES)
    reached = set()
    for name, (M, N, K, dtype, offset) in cases.items():
        x = at_offset(torch.randn((M, N), generator=gen, device="cuda").to(dtype), offset)
        idx = at_offset(torch.randint(0, M, (K, N), generator=gen, device="cuda",
                                      dtype=torch.int32), offset)
        ref = row_gather_plain(x, idx)
        for bits in (None, 32, 64):
            got = row_gather(x, idx) if bits is None else _row_gather_launch(x, idx, bits)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"row gather vs plain, case {name}, index bits {bits}")
            reached.add((str(dtype), bits or _row_index_bits(M, N, K)))
        emit({"case": "row_gather", "name": name, "table": [M, N], "index": [K, N],
              "dtype": str(dtype), "x_offset_bytes": x.data_ptr() % 16,
              "index_bits": _row_index_bits(M, N, K), "max_abs_err": 0.0})
        del x, idx, ref, got
    torch.cuda.empty_cache()
    M, N, K, dtype = ROW_WIDE
    x = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, M, (K, N), generator=gen, device="cuda", dtype=torch.int32)
    out = row_gather(x, idx)
    torch.cuda.synchronize()
    bits = _row_index_bits(M, N, K)
    ends = all(torch.equal(out[rows], row_gather_plain(x, idx[rows]))
               for rows in (slice(0, 1), slice(K - 1, K)))
    emit({"case": "row_gather_wide_index", "table": [M, N], "index": [K, N],
          "elements": K * N, "dtype": str(dtype), "index_bits": bits,
          "first_last_rows_equal": ends})
    if bits != 64 or not ends:
        raise AssertionError(f"row gather, {K * N} index elements, {bits}-bit indices: "
                             f"first and last rows equal: {ends}")
    reached.add((str(dtype), "wide", 64))
    del x, idx, out
    torch.cuda.empty_cache()
    need = ({(dt, b) for dt in ("torch.float32", "torch.bfloat16") for b in (32, 64)}
            | {("torch.bfloat16", "wide", 64)})
    if need - reached:
        raise AssertionError(f"row gather instances never run: {sorted(need - reached, key=str)}")
    emit({"row_gather_instances_checked": len(need)})


def bf16_backward_check(got: torch.Tensor, ref: torch.Tensor):
    """A bf16 gradient against its reference: ``(max ulps, elements beyond
    BWD_BF16_ULPS, passed)``, where an element beyond it passes if within
    BWD_FP32_TOL of the reference's max abs (a cancelling fp32 sum)."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs())
    _, exp = torch.frexp(mag)
    ulps = (g - r).abs() / torch.ldexp(torch.ones_like(mag), exp - 8).clamp_min(2.0 ** -133)
    beyond = ulps > BWD_BF16_ULPS
    worst = (g - r).abs()[beyond].max().item() if beyond.any() else 0.0
    return ulps.max().item(), int(beyond.sum()), worst <= BWD_FP32_TOL * r.abs().max().item()


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``|out - ref|`` in units of the bf16 spacing at
    ``max(|out|, |ref|)`` (8 significant bits)."""
    mag = torch.maximum(out.abs(), ref.abs())
    _, exp = torch.frexp(mag)   # mag = m * 2**exp with m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8).clamp_min(2.0 ** -133)
    return ((out - ref).abs() / ulp).max().item()


def smooth_texture(rng, h: int, w: int) -> np.ndarray:
    """A smooth random RGB texture in [0, 1]: bilinear upsampling of coarse noise."""
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 2, w // 16 + 2), dtype=np.float32))
    fine = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    return fine[0].permute(1, 2, 0).numpy()


def frames(tex: np.ndarray, h: int, w: int, shift, t: float):
    """Frame 0, frame 1 shifted by ``shift`` pixels, and the texture shifted
    by ``t * shift`` (the ideal frame at ``t``), all uint8 ``(h, w, 3)``."""
    dy, dx = shift
    y, x = 8, 8

    def crop(oy, ox):
        return (tex[y + oy:y + oy + h, x + ox:x + ox + w] * 255).astype(np.uint8)

    return crop(0, 0), crop(dy, dx), crop(round(t * dy), round(t * dx))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3], sys.argv[5:]))
    try:
        sys.exit(main())
    finally:
        stop_render_pool()
