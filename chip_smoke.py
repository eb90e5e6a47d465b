#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (recnext_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc per
source, started together; the checks that time nothing on the host and need no
peeled level, phases 2, 4 for a1 and the L models, 7, 7l, 11, 12, 15, 16 and 18l-19l's
gradients, run while the peeled level's library, the longest build, is compiled),
then drives eleven paths (the packed executor's the eleventh), each with every kernel launch
count set to 0 just before its main phase (serving; for training, the trainer)
and read just after:

1. env        card name and power limit, torch/CUDA versions, kernel build times;
   recnext_m1 (the M family, kernel K1 = RecConv2d):
2. kernel     the RecConv2d kernel against its plain PyTorch version at recnext_m1's
              four mixer shapes (224^2), an odd 15^2 plane, a 96^2 plane, two shapes
              whose N*C leaves the last block ragged and a non-square plane at each
              team size, bilinear, and nearest at m1's four shapes, 15^2 and 13x9 at
              level 4; in f32 (cuDNN TF32 off; tolerance 2e-5 max|ref|) and in bf16
              (against the plain version in f32 on the same bf16 values; tolerance
              1e-2 max|ref|, bf16 keeps 8 bits); prints each shape's launch
              configuration (team, planes per block, shared bytes) and the kernel's
              registers and local bytes per thread; times kernel and plain version
              at batch 256 bf16 (device time from a torch.profiler trace, and call
              time from CUDA events, which includes the host's time between
              launches);
3. large_plane planes too large for the kernel's shared memory (160^2 and 200x334 at
              level 4, batch 2, C = 48), which peel outer levels, each peeled level
              two launches of the level kernel (csrc/recconv_level_bwd.cu:
              recconv_level_kernel): against the plain version at phase 2's bounds,
              with the launches and peels made; then the level kernel alone at the two
              shapes of m1's 640^2 path (the 160^2 down conv and the 80^2 -> 160^2
              upsample-add-conv, bilinear and nearest, bf16, batch 2) and at COCO's
              200x334 down conv (bf16, an odd coarse width), against its plain version
              and its own bits on three runs, timed as phase 2 does at m1's, and its
              registers;
4. model      recnext_m1 from a seeded generator, BN statistics calibrated on a
              random batch, fused with fuse_params; the fused model's logits through
              the kernel against the plain path (f32 and bf16), and exactly 23
              RecConv2d and 0 linear-attention launches per forward: at 640^2
              (batch 2; 3 calls a forward peel a level: 6 level-kernel launches), in
              nearest mode, and at 224^2 (0 level-kernel launches);
5. serving    publish_fused -> ServingModel(max_batch=8) -> HTTP server: /ping,
              /models/recnext_m1, then >= 16 requests from several threads through
              the micro-batcher (the path a POST takes after decoding), each equal
              to a direct predict; the main path whose kernel launches are counted;
6. throughput fused bf16 m1 at batch 256 and batch 1, timed with CUDA events, through
              the kernel and (for scale) with the mixers on the plain version; a
              profiler trace of the kernel path: device busy time and idle share,
              the kernel's time in the forward, the kernels by device time;
6p. packed     the packed executor (models/packed_infer.py, PackedRecNext) on the
              serving phase's fused bf16 m1 at batch 256 and 8: in f32 (batch 256 and
              8, g = 2 and 4 at every stage) the logits within atol 2e-4, rtol 2e-5 of
              the unpacked fused model's; in bf16 at default_groups, g = 2 and g = 4, each
              forward's distance from the f32 logits at most the unpacked bf16
              forward's plus 1e-2 max|ref| (the distance between the two bf16 forwards
              printed), and exactly 23 K1 launches a forward (no other kernel); the
              packed and the unpacked forward's ms at batch 256; one request through
              ServingModel(packed=None) with g = 2 in the policy table; the packing
              sweep (tools/sweep_packing.py: 1,1,1,1 / 2,1,1,1 / 1,2,1,1 / 1,1,2,1 /
              1,1,1,2 at batch 256); micro.bench_stage2_packed and bench_eval's packed
              step;
   recnext_a1 (the A family, kernel K2 = linear attention):
7. attention  the linear-attention kernel against its plain version (kv-first) at
              tests/test_pallas.py's four shapes (odd n, odd d, dv != d), at
              recnext_a1's four attention shapes, at heads that start off 16-byte
              alignment and at N = 1, through the (BH, N, D) entry and the model's
              NCHW head entry: f32 within 1e-3 + 1e-3 |ref| (tests/test_pallas.py:44's
              bound), bf16 against the plain version in f32 on the same bf16 values
              within 1e-2 max|ref|; prints each shape's launch configuration and the
              kernel's registers and local bytes; times kernel and plain version at
              a1's shapes at batch 256 bf16, as phase 2 does;
8-10.         phases 4-6 for recnext_a1 (at 224^2): exactly 23 linear-attention and
              0 RecConv2d launches per forward, and 23 per batch served;
10p.          phase 6p for recnext_a1 (23 K2 launches a packed forward, K2 on the
              (B, 2c, H, W) views of the packed qk), with tools/attn_breakdown.py at
              stages 1-2 (default_groups and g = 2); the packed path's kernels do the
              work of the unpacked path's on the same planes and heads, so phases 2
              and 7 time both;
   the L family (recnext_t/b/t_share_channel; K2 at one head per image, D up to 96,
   DV != D in LA3, whose v is a channel slice of the block's input; no RecConv2d):
7l. attention_l  K2 at the seven L shapes (L_ATTENTION) through the NCHW entry (the
              slice read in place: its batch stride is C*H*W) and the (BH, N, D)
              entry at batch 8 and 256, at phase 7's bounds, the same bits on three
              runs; each shape's launch configuration; device times at batch 256
              bf16 on the checked inputs beside bound and plain version (K2 must not
              be slower), and the sums
              over each L model's forward;
8l-10l.       phase 4 for recnext_t, recnext_b and recnext_t_share_channel at full
              width (RepVGGDW fused): exactly 20 / 30 / 18 K2 launches and 0
              RecConv2d and level-kernel launches per forward; phases 5-6 for
              recnext_t: 20 K2 launches per batch served;
   recnext_m1 training (K1 and the RecConv2d backward kernel, csrc/recconv_bwd.cu):
11. backward  the backward kernel against its plain version (autograd over
              rec_conv2d in fp32, cuDNN TF32 off) at m1's four training shapes, batch
              128, f32 (dx within 2e-5 max|ref|, dW within 1e-4 max|ref|: sums over
              N*H*W terms) and bf16 (1e-2 max|ref|), bilinear and nearest; device
              times at bf16 bilinear, each shape's bound, its launch configuration
              (team, planes per block, shared bytes, resident blocks per SM) and the
              kernel's registers and local bytes;
12. train_grad recnext_m1 at full size, 224^2, batch 8, f32, train mode: every
              parameter's gradient through the kernels against the plain path;
13. train     the trainer (train.main.main): m1, FAKE, --simple-aug, 224^2, batch
              64, 2 epochs of 3 steps, then a rerun to 3 epochs that resumes: finite
              losses, exactly 23 K1 launches and 23 backward calls per train step
              (and 23 K1 launches per fused eval forward), the epoch lines and the
              checkpoint files; the main path whose launches are counted;
14. train_throughput  bench.train_throughput("recnext_m1", 128) with 2 repeats: the
              median img/s, the spread and the step ms, and a profiler trace of 2
              steps (top kernels, the backward kernel's share, the idle share) that
              must list 23 launches a step of each of the port's kernels;
   recnext_a1 training (K2 and its backward kernel K2', csrc/linear_attention_bwd.cu,
   with the reference recipe's hard distillation from a seeded regnety_160):
15. attention_backward  K2' against its plain version (autograd over the kv-first
              form in fp32) at tests/test_pallas.py's shapes, a1's four training
              shapes at batch 128, DV != D (12, 24), D = DV = 128, heads off 16-byte
              alignment and N = 1, through the (BH, N, D) and the NCHW entries:
              each gradient f32 within 2e-5 max|ref|, bf16 within 1e-2 max|ref|, the
              same bits on three runs, at every route of K2' (heads packed in a
              block, a head split over a thread-block cluster, the tiled walk)
              and at head counts that leave a packed block or a cluster's last
              slice partly filled; each shape's launch configuration (route,
              team, heads a block, cluster, shared bytes) with its kernel's
              registers and resident blocks an SM, device times at a1's shapes
              (batch 128, bf16;
              CUDA events around calls queued behind other work, back to back and
              with L2 flushed before each call; the profiler's beside) beside bound
              and plain, and their sums over one a1 train step's 23 calls;
16-17.        phases 12-13 for recnext_a1: its full-size gradients through K2 and
              K2' against the plain path; the trainer with --distillation-type hard
              --teacher-model regnety_160: 23 K2 launches and 23 K2' calls per train
              step, 23 K2 launches per fused eval forward, nothing of K1 or K1';
18. train_throughput  phase 14 for recnext_a1, without and with the regnety_160
              hard teacher, and the distilled step's cost over the plain one;
   the export CLI, the trainer's remaining flags, two processes (no new kernel):
18e. export   the export CLI (python -m recnext_tpu_torch.export --torch-export) on m1
              from phase 13's checkpoint with --ema and on a calibrated a1
              (--torch-ckpt), bf16 at batch 8, and export_program at batch 256: a
              spawned process loads each program (torch.export.load after importing
              recnext_tpu_torch.ops, where K1 and K2 are custom ops) and runs it on the
              card: exactly 23 K1 (m1) or 23 K2 (a1) launches and none of the other a
              forward, the logits within the model phase's bf16 tolerance of the eager
              fused model's (the max difference printed), the forward ms of both at
              batch 8 and 256;
18f. train_flags  m1 (FAKE, 224^2, batch 32, 2 steps an epoch) with --ckpt-every-steps 1
              --eval-ema, --resume from its recovery.pt with --eval-ema
              --export-teacher, then recnext_a1 hard-distilled from that teacher
              (--teacher-model recnext_m1 --teacher-ckpt): each run's launches (23 K1
              and 23 K1' a step, 23 K1 an eval forward; a1 23 K2 and 23 K2' a step and
              23 K1 a step for the teacher), the recovery and resume lines, no EMA
              keys under --eval-ema;
18p. two_process  m1's train step (bf16, mixup, 224^2) as 2 spawned processes on the one
              card (the export check's pool, started before the exports) (gloo on CUDA tensors) against one process at the same global batch
              of 64: the step-0 losses within 1e-2, 23 K1 and 23 K1' launches a step in
              each process, the step ms of both, the gradient all-reduce's bytes and
              ms;
   recnext_t training (K2 and K2' at the L shapes):
18l. attention_backward_l  K2' at the seven L shapes through the NCHW entry, LA3's v
              a channel slice, at batch 16 and, at recnext_t's three shapes, 128
              (phase 15's bounds, the same bits on three runs), each launch
              configuration, device times at recnext_t's three shapes at batch 128
              bf16 on the checked inputs beside bound and plain, and their sum over a
              step's 20 calls;
19l-21l.      phases 12-14 for recnext_t: its full-size gradients through K2 and
              K2'; the trainer (20 K2 and 20 K2' a train step, 20 K2 a fused eval
              forward); train throughput at batch 128 (2 repeats of 1.5 s);
   recnext_m1 training beyond the main paths (planes larger than K1′'s shared memory
   through the peeled level's backward kernels, csrc/recconv_level_bwd.cu, and the
   384^2 finetune recipe):
19. large_plane_backward  K1′'s peeled route at 128^2 L4 (C 48, batch 2: a 512^2
              input's stage 0, one level peeled) and 200x334 L4 (C 48, batch 1: COCO's,
              two levels) against its plain version, f32 and bf16, bilinear and
              nearest, at K1′'s bounds, each call's peels (1 and 2) and launches
              (per peeled level: the level kernel and K1 recomputing d and y, KL′1
              and KL′2 twice, KL′3 once; then one K1′ call) asserted, and the same
              bits on three runs in every dtype and mode; then each of the three
              level kernels (the input gradient at stride 1 and 2, the weight gradient
              at stride 1 with z = x + up(y) and at stride 2, the up-step's adjoint)
              against its plain version and its own bits on three runs at the outer
              level's shapes of both planes, timed with CUDA events around queued
              calls beside its bound (and the ratio, over_bound), its plain version
              and one PyTorch call of the same function (torch.nn.grad.conv2d_input /
              conv2d_weight with groups=C, aten.upsample_*2d_backward), with its
              registers and local bytes;
20. train_grad recnext_m1 at 512^2, batch 2, f32: phase 12 at the size where stage
              0's three mixers peel a level in their backward: every K1' call, each
              of the three level kernels and the recomputed inner pyramids counted;
21. finetune  the trainer finetunes recnext_m1 (full width and depth) at 384^2 on FAKE
              data of 100 classes (the 1000-class head dropped and reinitialised),
              warm-started from phase 13's checkpoint and from a fused archive of its
              EMA weights, with --grad-accum 2 --remat --mesa 1.0
              --mesa-start-ratio 0 for 4 micro-steps: 69 K1 launches a micro-step (the
              forward, its recomputation, the EMA model's), 23 K1' calls, 23 K1
              launches a fused eval forward; validate.py --fused --results-file scores
              the result and its CSV row is read back; then the recipe's step timed
              (bench.train_throughput at 384^2, batch 64) with a profiler trace: img/s,
              the idle share, K1 and K1' launches a micro-step.
   the data pipeline (recnext_tpu_torch/data/; no kernel of its own):
22. input_pipeline  the host's CPU count and affinity and /dev/shm, and the native
              decoder's build (native/recnext_io.cpp, g++, the repository's jpeg62
              headers and Pillow's libjpeg), which must succeed; 256
              500x375 JPEGs of 10 classes (bench.make_folder), listed 2 times, and a
              copy with PNGs; the loader's img/s at 224^2 for PIL and native, full and
              simple transform, at workers 0 and W = min(16, CPUs); the same bits in
              the first 3 batches at workers 0 and W on each route that builds, and
              the native fallback's count (0 on JPEGs, above 0 with PNGs); the trainer
              on m1 from the folder with the full recipe, RA, batch 128, one epoch of
              4 steps, with --workers W, with --native-loader at workers 0 and at
              W: 23 K1
              launches and 23 K1' calls a train step, its img/s beside phase 14's
              step alone and the idle share from that phase's busy time a step;
              validate.py --fused --ema on the val split, PIL and native.
   the MLLA graft family (mlla_mini at 256^2; K1 and K1′ in nearest mode in
   mlla_mini_recconv, K2 and K2′ in mlla_mini_recattn_simple, mlla_mini_recattn's RoPE
   attention plain PyTorch), run last, in a process of their own:
23. mlla_kernels  K1 and K1′ at mlla_mini_recconv's four shapes (MLLA_K1: 64^2x60 L4 up
              to 8^2x480 L1) and K2 and K2′ at mlla_mini_recattn_simple's seven
              (MLLA_K2: N 1024 D 24 down to N 16, D 24 and 48), each against its plain
              version at phases 2, 7, 11 and 15's bounds on the inputs it is then timed
              on (forward batch 256, f32 and bf16, and batch 8; backward batch 128; K2′
              the same bits on three runs), each shape's launch configuration (K2′'s
              route and cluster), device times beside bound and plain version (each
              kernel must beat its plain version), and the sums over a forward / step;
24. mlla_model  the three mini variants at full width, batch 8, eval mode, unfused:
              logits through the kernels against the plain path (f32 and bf16) with 21
              K1 / 21 K2 / 0 launches a forward; in train mode (f32), every gradient
              through K1 and K1′ or K2 and K2′ against the plain path, 21 calls of
              each a step;
25. mlla_throughput  mlla_mini_recconv and _recattn_simple, bf16, batch 256 and 1: ms
              and img/s, the device's busy time and idle share, the kernel's and the
              layout copies' time, the top kernels;
26. mlla_train  bench.train_throughput at batch 128 with the MLLA recipe (norm clip
              5.0, MESA 1.0) for both, with a trace (42 forward-kernel launches and 21
              backward calls a step); then the trainer from --config
              configs/mlla_mini_300e.yaml on mlla_mini_recconv (FAKE, batch 64, PyYAML
              unimportable), 2 epochs of 3 steps and a resume: 21 K1′ calls a step, 21
              K1 launches per train, MESA and eval forward.
   the downstream tasks (recnext_m3 Semantic FPN at 512^2, RetinaNet and Mask R-CNN at
   800^2, batch 16, fp32 as the task CLIs run, each from a seeded classifier with
   calibrated BN through --init-ckpt; recnext_a3's attention shapes), run last, in a
   process of their own:
27. tasks_seg  the train_seg CLI with the seg preset on FAKE: 3 iterations, a --resume
              to 6, --eval-only, --benchmark 5, each run's launches equal to the
              planners' (m3_task_launches: a step K1 21 + 3, the level kernel 3, K1′ 21,
              KL′1-3 6/6/3; a forward K1 21); the backbone's BN statistics the same
              bits after the steps, the head's moved; one train step traced (ms,
              img/s, idle share, kernels, peak memory);
28. tasks_grad  m3's Semantic FPN at batch 2 in train mode: logits and every gradient
              through the kernels against the plain path (a3's too, phase 31);
29. tasks_recconv, tasks_level_backward  K1 and K1′ at m3's task shapes (the seg
              path's four planes, det's stage 0 at 200^2) and KL′1-3 alone at 128^2 x 64
              and 200^2 x 64, batch 16, fp32, as in phase 19 (bound, over_bound, plain
              version, library call, registers, the same bits on three runs), the
              launches of one peeled backward call there against
              peeled_backward_launches; and K1's level kernel there (tasks_level_kernel:
              the stride-2 down conv, beside F.conv2d(stride=2, groups=C), and the
              upsample-add-conv, bilinear, and nearest checked only), against its plain
              version and its own bits on three runs, beside its bound;
30. tasks_det  the train_det CLI, --detector retinanet, the det preset on FAKE: 2
              epochs of 3 steps and the AP loop over 16 images, a --resume, --eval-only
              and --benchmark 3 (a forward also 6 level-kernel launches); one step
              traced; the post-process's ms an image;
30m. tasks_mask_rcnn  the train_det CLI, --detector mask_rcnn --with-mask (128
              proposals an image), the det preset on FAKE: an epoch of 3 steps and the
              AP loop over 16 images (bbox and segm AP), --eval-only and --benchmark 3,
              launches as tasks_det's, finite loss terms; one step traced, its stages
              outside the backbone (proposals, the RoIAligns, the RoI heads, the loss)
              timed, the predict call and paste_masks an image; tasks_mask_rcnn_grad:
              batch 2, the same proposals on every path and the heads' ReLUs pinned,
              the outputs and every gradient through the kernels against the plain
              path (as phase 28);
31. tasks_attention  K2 and K2′ at a3's four 512^2 shapes (N 4096 ... 64, D 32),
              batch 16, f32 and bf16, K2′ the same bits on three runs, timed in f32.
   the measurement tools (recnext_tpu_torch/tools/; no kernel of their own), in the
   main process after the tasks:
32. tools     the roofline (tools/roofline.py: the work counted on the host's CPU on
              the plain path, an H100 engine model) of fused m1, a1 and recnext_t at
              224^2 and eval-mode mlla_mini_recconv at 256^2 against the img/s of
              phases 6, 10, 10l and 25 at batch 256, and of m1's train step at batch
              128 against phase 14's: each share in (0, 100]; m1's stage breakdown
              (0 / 3 / 3 / 15 / 2 K1 launches in the stem and stages 0-3) and its
              train-step breakdown at batch 128 (23 K1 and 23 K1' launches in the
              full step); the taps and Winograd depthwise forms and the taps
              gradients against cuDNN in f32 at m1's shapes (taps and F(2,5) 2e-5,
              F(4,5) 2e-3 max|ref|; gradients 2e-5 / 1e-4); the micro-benchmarks
              (micro.py, bwd_micro.py) at m1's shapes, a JSON line a row; bench_all
              over m0 and m1 with 1 s windows (no error row), merge_results and a
              model card of its m1 row naming the card; analyze_logs over phase 13's
              log.txt.
Then each phase's seconds, the L path's launch counts and K2 / K2' totals, the
MLLA path's (the mlla_path line), the tasks' (the tasks_path line), the tools'
roofline shares (the tools_path line) and the packed executor's launches and sweeps
(the packed_path line).

Every phase prints one JSON line. Any failure raises and the exit code is not 0.
In the kernel record, "launches" counts the launches of the kernel's serving
phase; "ms", "plain_ms" (device times) and "bound_ms" are the sums over the 23
launches of one forward of its model (m1 for rec_conv2d, a1 for linear_attention)
at batch 256 in bf16. The level kernel (rec_conv2d_level) runs only where a plane
is too large for K1: its record's launches are those of one m1 forward at 640^2,
and its times the sums over that forward's 6 launches at batch 2 in bf16. The
backward kernel's (rec_conv2d_backward) launches are its calls in the train phase's
first run, and its times the sums over one m1 train step's 23 calls at batch 128 in
bf16; K2' (linear_attention_backward) likewise, for a1's train phase and train
step (times back to back; the phase also gives them with L2 flushed before each
call). The peeled level's backward kernels (rec_conv2d_level_dgrad, _wgrad,
rec_conv2d_up_adjoint) run only where a plane's backward is too large for K1': their
launches are those of phase 20's kernel path (m1 at 512^2, batch 2), and their times
the sums over that step's launches (3 peeled mixers, each 2 input-gradient, 2
weight-gradient and 1 adjoint launches at 128^2, batch 2, C 48). The packed
executor's K1 and K2 launches a forward are on the packed_path line. The L path's K2 and
K2' numbers are on the l_path line, the MLLA path's on the mlla_path line, not in
the kernel record. The last lines are
the kernel record, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from recnext_tpu_torch import bench
from recnext_tpu_torch import validate as validate_main
from recnext_tpu_torch.export import publish_fused
from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.mlla import create_mlla
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.ops.attention import (
    _nchw_views,
    linear_attention_backward,
    linear_attention_backward_plain,
    linear_attention_fused,
    linear_attention_kv_first,
    linear_attention_nchw,
    linear_attention_nchw_backward,
    linear_attention_nchw_plain,
)
from recnext_tpu_torch.ops.cuda import linear_attention as attention_cuda
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as attention_bwd_cuda
from recnext_tpu_torch.ops.cuda import recconv as recconv_cuda
from recnext_tpu_torch.ops.cuda import recconv_bwd as recconv_bwd_cuda
from recnext_tpu_torch.ops.cuda import recconv_level_bwd as level_bwd_cuda
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d,
    rec_conv2d_backward,
    rec_conv2d_backward_plain,
    rec_conv2d_fused,
    rec_conv2d_level,
    rec_conv2d_level_dgrad,
    rec_conv2d_level_dgrad_plain,
    rec_conv2d_level_plain,
    rec_conv2d_level_wgrad,
    rec_conv2d_level_wgrad_plain,
    rec_conv2d_up_adjoint,
    rec_conv2d_up_adjoint_plain,
)
from recnext_tpu_torch.ops.resize import resize
from recnext_tpu_torch.serve import ServingModel, make_server
from recnext_tpu_torch.train import main as train_main
from recnext_tpu_torch.train.finetune import read_weights
from recnext_tpu_torch.train.step import train_loss

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside
# the tensor cores, which is what the kernel's arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
M1_MIXERS = {  # level -> (channels, plane side, launches per m1 forward) at 224^2
    4: (48, 56, 3), 3: (96, 28, 3), 2: (192, 14, 15), 1: (384, 7, 2)}
# stage -> (heads, side of the attention map, launches per a1 forward, variant) at
# 224^2; the head width is 24 at every stage
A1_ATTENTION = {0: (2, 28, 3, 1), 1: (4, 14, 3, 1), 2: (8, 7, 15, 1), 3: (16, 4, 2, 2)}
A1_HEAD_DIM = 24
# the L family's attention shapes at 224^2, one head per image: (side of the map, D,
# DV, variant, channels of the block's input whose first DV channels are v: LA3 reads
# v as a channel slice; 0 where v is a tensor of its own) -> launches per forward of
# each L model on the main path
L_ATTENTION = {
    (7, 32, 32, 2, 0): {"recnext_t": 2, "recnext_t_share_channel": 2},
    (4, 64, 64, 2, 0): {"recnext_t": 8},
    (4, 64, 128, 2, 512): {"recnext_t": 10, "recnext_b": 12, "recnext_t_share_channel": 8},
    (14, 32, 32, 1, 0): {"recnext_b": 2},
    (7, 64, 64, 2, 0): {"recnext_b": 8},
    (4, 96, 96, 2, 0): {"recnext_b": 8},
    (7, 32, 64, 2, 256): {"recnext_t_share_channel": 8},
}
L_MODELS = ("recnext_t", "recnext_b", "recnext_t_share_channel")
# K2 launches per forward (and K2' calls per train step) of each model
MIXERS = {"recnext_m1": 23, "recnext_a1": 23} | {
    name: sum(uses.get(name, 0) for uses in L_ATTENTION.values()) for name in L_MODELS}
# every launch count; each path's serving phase sets them all to 0 before it runs
COUNTERS = {"rec_conv2d": rec_conv2d_fused, "rec_conv2d_level": rec_conv2d_level,
            "linear_attention": linear_attention_fused,
            "rec_conv2d_backward": rec_conv2d_backward,
            "linear_attention_backward": linear_attention_backward,
            "rec_conv2d_level_dgrad": rec_conv2d_level_dgrad,
            "rec_conv2d_level_wgrad": rec_conv2d_level_wgrad,
            "rec_conv2d_up_adjoint": rec_conv2d_up_adjoint}
LEVEL_BWD = ("rec_conv2d_level_dgrad", "rec_conv2d_level_wgrad", "rec_conv2d_up_adjoint")
EXPECTED = {"recnext_m1": dict.fromkeys(COUNTERS, 0) | {"rec_conv2d": 23}} | {
    name: dict.fromkeys(COUNTERS, 0) | {"linear_attention": MIXERS[name]}
    for name in ("recnext_a1", *L_MODELS)}
# each training path's kernels: (forward kernel, its backward), MIXERS[name] calls
# each a step
TRAIN_KERNELS = {"recnext_m1": ("rec_conv2d", "rec_conv2d_backward"),
                 "recnext_a1": ("linear_attention", "linear_attention_backward"),
                 "recnext_t": ("linear_attention", "linear_attention_backward")}
# the train phases' runs: FAKE, 224^2, batch 64, 2 epochs of 3 steps; each epoch's eval
# scores 3 batches (capped by --steps-per-epoch) with the model and the EMA. recnext_a1
# trains with the reference recipe's hard distillation from a (seeded) regnety_160
TRAIN_ARGS = ["--model", "recnext_m1", "--data-set", "FAKE", "--simple-aug",
              "--input-size", "224", "--batch-size", "64", "--steps-per-epoch", "3",
              "--log-every", "1", "--seed", "0"]
A1_TRAIN_ARGS = [a if a != "recnext_m1" else "recnext_a1" for a in TRAIN_ARGS] + [
    "--distillation-type", "hard", "--teacher-model", "regnety_160"]
T_TRAIN_ARGS = [a if a != "recnext_m1" else "recnext_t" for a in TRAIN_ARGS]
TEACHER = "regnety_160"
TRAIN_STEPS_PER_EPOCH, EVAL_FORWARDS_PER_EPOCH = 3, 2 * 3
# m1 at 640^2: its 3 stage-0 mixers (160^2, level 4) each peel one level
M1_640_LEVEL_LAUNCHES = 6
# m1's train step at 512^2, batch 2, f32: the 3 stage-0 mixers (128^2, level 4) peel one
# level of their backward, which recomputes d (a level-kernel launch) and the inner
# pyramid (a K1 launch), and calls K1' on the 64^2 plane at level 3 and each level
# kernel of the peeled level: 2 input gradients, 2 weight gradients, 1 adjoint
M1_512_TRAIN = dict.fromkeys(COUNTERS, 0) | {
    "rec_conv2d": 23 + 3, "rec_conv2d_level": 3, "rec_conv2d_backward": 23,
    "rec_conv2d_level_dgrad": 6, "rec_conv2d_level_wgrad": 6, "rec_conv2d_up_adjoint": 3}
# the peeled backward's planes: a 512^2 input's stage 0 and COCO 1333x800's (n, c, h, w)
LARGE_BWD = ((2, 48, 128, 128), (1, 48, 200, 334))
# the finetune phase: m1 at 384^2 on 100 classes, batch 32, 4 micro-steps of 2 an
# update, remat and MESA from the start; each epoch's eval scores 4 batches twice
FINETUNE_ARGS = ["--model", "recnext_m1", "--data-set", "FAKE", "--simple-aug",
                 "--input-size", "384", "--fake-classes", "100", "--batch-size", "32",
                 "--epochs", "1", "--steps-per-epoch", "4", "--log-every", "1",
                 "--grad-accum", "2", "--remat", "--mesa", "1.0", "--mesa-start-ratio", "0"]
FINETUNE_STEPS, FINETUNE_EVALS = 4, 2 * 4
# the MLLA graft family's main path: mlla_mini (embed 48, depths 2/4/8/4) at 256^2.
# K1 (nearest) in mlla_mini_recconv: level -> (channels, plane side, launches a forward)
MLLA_K1 = {4: (60, 64, 2), 3: (120, 32, 5), 2: (240, 16, 9), 1: (480, 8, 5)}
# K2 in mlla_mini_recattn_simple: (heads, side of the attention map, D = DV) -> launches
MLLA_K2 = {(2, 32, 24): 2, (2, 16, 48): 1, (4, 16, 24): 4, (4, 8, 48): 1, (8, 8, 24): 8,
           (8, 4, 48): 1, (16, 4, 24): 4}
MLLA_SIDE, MLLA_BATCH, MLLA_TRAIN_BATCH = 256, 256, 128
# each variant's kernels (forward, backward): 21 launches of each a forward / step;
# recattn's RoPE attention is plain PyTorch (no kernel)
MLLA_KERNELS = {"recconv": ("rec_conv2d", "rec_conv2d_backward"),
                "recattn_simple": ("linear_attention", "linear_attention_backward"),
                "recattn": ()}
MLLA_MIXERS = 21
MLLA_TRACE = {"recconv": ("recconv_kernel", "recconv_bwd_kernel", "recconv_bwd_sum_kernel"),
              "recattn_simple": ("linear_attention_kernel", "linear_attention_bwd_")}
# the trainer with the MLLA recipe's preset (no PyYAML on its path): FAKE, 256^2, the
# preset's augmentation, batch 64, 2 epochs of 3 steps, then a resume to 3. MESA starts
# at int(0.25 * epochs * 3): steps 1-5 of the first run and all 3 of the resume take
# the EMA model's forward too; each epoch's eval scores 3 batches with model and EMA
MLLA_TRAIN_ARGS = ["--config", "configs/mlla_mini_300e.yaml", "--model", "mlla_mini_recconv",
                   "--data-set", "FAKE", "--batch-size", "64", "--steps-per-epoch", "3",
                   "--log-every", "1"]
MLLA_MESA_FORWARDS = {2: 5, 3: 3}
# every bench.train_throughput call: its timed windows and their seconds (2 of 1.5 s: the
# median and the spread stay on record in a run that fits its time limit)
TIMED_REPEATS, TIMED_S = 2, 1.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace(fn, iters: int = 20, warmup: int = 3, attempts: int = 3):
    """The device kernels of ``iters`` calls, from a torch.profiler trace: a list of
    {name, launches, ms} per call, most device time first. User annotations (such as
    ``Optimizer.step#AdamW.step``) are left out: on the device's timeline they span
    kernels that are counted on their own. A trace that saw no device activity at
    all is taken again (at most ``attempts`` times)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [{"name": e.key[:100], "launches": e.count / iters,
                    "ms": e.self_device_time_total / 1e3 / iters}
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and not e.is_user_annotation]
        if kernels:
            return sorted(kernels, key=lambda k: k["ms"], reverse=True)
    raise RuntimeError(f"the profiler saw no device time in {attempts} traces")


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the kernels' times summed. Unlike ``cuda_ms`` it leaves
    out the host's time between launches, which bounds a call at small shapes."""
    return sum(k["ms"] for k in trace(fn, iters))


def queued_ms(fn, iters: int = 20, ahead: int = 6, attempts: int = 5) -> float:
    """Device ms per call from CUDA events around ``iters`` calls queued behind
    ``ahead`` bf16 8192^2 matmuls (about 1.5 ms each), so that the host's time per call
    is hidden: the device runs the calls back to back. That holds only if the device
    has not reached the start event when the host has queued the last call; on a slow
    or shared host it may have, the queue ran dry and the time is the host's. Then
    the calls are timed again behind twice as many matmuls (at most ``attempts``
    times; a last time still uncovered is reported on stderr)."""
    a = torch.ones(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(ahead << attempt):
            a @ a
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            break
    else:
        print(f"chip_smoke: queued_ms: {iters} calls outran {ahead << attempt} matmuls; "
              "the time includes the host's", file=sys.stderr, flush=True)
    return start.elapsed_time(end) / iters


def time_pair(kernel, plain):
    """Device ms per call of the kernel and of its plain version, and each one's
    ms per call from CUDA events (host time between launches included)."""
    return {"kernel_ms": device_ms(kernel), "plain_ms": device_ms(plain, iters=5),
            "kernel_call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain, iters=5)}


def recconv_work(n, c, h, w, level, k, elem_bytes):
    """(bytes, flops) the RecConv2d function needs: x read and y written once (and
    the weights), 2k^2 flops per output of each of its 2*level+1 convolutions, and
    10 per upsampled output (three lerps and the add)."""
    sizes = [(h, w)]
    for _ in range(level):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    area = [a * b for a, b in sizes]
    conv_outputs = 2 * sum(area[1:]) + area[0]
    up_outputs = sum(area[:-1])
    flops = n * c * (2 * k * k * conv_outputs + 10 * up_outputs)
    nbytes = elem_bytes * (2 * n * c * h * w + (level + 2) * k * k * c)
    return nbytes, flops


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_recconv(x, ws, level, mode):
    """K1 against its plain version on x (f32) and on x rounded to bf16: the max
    errors and max |ref|; raises beyond 2e-5 max|ref| (f32) or 1e-2 max|ref| (bf16)."""
    want = rec_conv2d(x, ws[0], ws[1:], level=level, mode=mode)
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level, mode=mode)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err32 = (got - want).abs().max().item()
    if not err32 <= 2e-5 * scale:
        raise AssertionError(f"f32 {mode} kernel mismatch at {tuple(x.shape)} L{level}: "
                             f"{err32} > 2e-5 * {scale}")
    xb, wsb = x.bfloat16(), [t.bfloat16() for t in ws]
    got16 = rec_conv2d_fused(xb, wsb[0], wsb[1:], level=level, mode=mode).float()
    want16 = rec_conv2d(xb.float(), wsb[0].float(), [t.float() for t in wsb[1:]],
                        level=level, mode=mode)
    scale16 = want16.abs().max().item()
    err16 = (got16 - want16).abs().max().item()
    if not err16 <= 1e-2 * scale16:
        raise AssertionError(f"bf16 {mode} kernel mismatch at {tuple(x.shape)} L{level}: "
                             f"{err16} > 1e-2 * {scale16}")
    return {"f32_max_abs_err": err32, "f32_max_abs_ref": scale,
            "bf16_max_abs_err": err16, "bf16_max_abs_ref": scale16}


def _recconv_inputs(gen, n, c, h, w, level, dtype):
    x = torch.randn(n, c, h, w, generator=gen)
    ws = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(level + 2)]
    return x.to("cuda", dtype), [t.to("cuda", dtype) for t in ws]


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    cases = [(64, c, s, s, level, "bilinear") for level, (c, s, _) in M1_MIXERS.items()]
    cases += [(64, 32, 15, 15, 2, "bilinear"), (8, 48, 96, 96, 4, "bilinear")]
    # N*C not a multiple of the planes per block, then a non-square plane at each team
    # size that k = 5 planes take (8, 32, 32, 128, 256 threads per plane)
    cases += [(n, c, h, w, level, "bilinear") for n, c, h, w, level in (
        (3, 5, 7, 7, 1), (1, 13, 14, 14, 2), (2, 11, 9, 14, 2), (2, 6, 20, 23, 3),
        (1, 5, 27, 30, 3), (1, 3, 45, 47, 2), (1, 2, 60, 75, 2))]
    # nearest plans: m1's four planes, 15^2 and 13x9 at level 4
    cases += [(64, c, s, s, level, "nearest") for level, (c, s, _) in M1_MIXERS.items()]
    cases += [(64, 32, 15, 15, 2, "nearest"), (16, 16, 13, 9, 4, "nearest")]
    per_shape = {}
    max_abs_err = 0.0
    for n, c, h, w, level, mode in cases:
        x, ws = _recconv_inputs(gen, n, c, h, w, level, torch.float32)
        errs = _check_recconv(x, ws, level, mode)
        cfg = recconv_cuda.launch_config(h, w, level, 5, 2)
        rec = {"phase": "kernel", "shape": [n, c, h, w], "level": level, "mode": mode,
               **errs,
               "launch": {"team": cfg.team, "planes_per_block": cfg.planes_per_block,
                          "shared_bytes": cfg.smem_bytes,
                          **recconv_cuda.kernel_attributes(5, torch.bfloat16)}}
        m1 = M1_MIXERS.get(level)
        if m1 and (c, h, w) == (m1[0], m1[1], m1[1]):
            max_abs_err = max(max_abs_err, errs["bf16_max_abs_err"])
        if m1 and (c, h, w) == (m1[0], m1[1], m1[1]) and mode == "bilinear":
            # timing at the main path's size: batch 256, bf16
            xt, wst = _recconv_inputs(gen, 256, c, h, w, level, torch.bfloat16)
            times = time_pair(lambda: rec_conv2d_fused(xt, wst[0], wst[1:], level=level),
                              lambda: rec_conv2d(xt, wst[0], wst[1:], level=level))
            nbytes, flops = recconv_work(256, c, h, w, level, 5, 2)
            bms, by = bound(nbytes, flops)
            per_shape[level] = dict(times, bytes=nbytes, flops=flops)
            rec.update(batch_256_bf16=dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                           flops=flops))
        emit(rec)
    return per_shape, max_abs_err


def level_work(n, c, h, w, k, stride, up, in_bytes, out_bytes):
    """(bytes, flops) of one level of a peeled pyramid: x (and the fp32 inner plane)
    read and y written once, and the fp32 weights; 2k^2 flops per output, and 10 per
    upsampled input where ``up``."""
    oh, ow = (h, w) if stride == 1 else ((h + 1) // 2, (w + 1) // 2)
    nbytes = n * c * (in_bytes * h * w + out_bytes * oh * ow + 4 * k * k)
    if up:
        nbytes += 4 * n * c * ((h + 1) // 2) * ((w + 1) // 2)
    return nbytes, n * c * (2 * k * k * oh * ow + (10 * h * w if up else 0))


def phase_large_planes():
    """Planes too large for K1's shared memory: 640^2's stage-0 plane (160^2 L4) and
    COCO 1333x800's (200x334 L4), batch 2, C = 48, at the kernel phase's bounds, with
    the launches and peels each made. Then the level kernel alone at the shapes of
    m1's 640^2 path, against its plain version on the same inputs, and timed."""
    gen = torch.Generator().manual_seed(6)
    for h, w, level in ((160, 160, 4), (200, 334, 4)):
        x, ws = _recconv_inputs(gen, 2, 48, h, w, level, torch.float32)
        before = counts(), rec_conv2d_fused.peeled
        errs = _check_recconv(x, ws, level, "bilinear")
        emit({"phase": "large_plane", "shape": [2, 48, h, w], "level": level, **errs,
              "levels_peeled": [recconv_cuda.levels_to_peel(h, w, level, 5, eb)
                                for eb in (4, 2)],
              "launches": {k: v - before[0][k] for k, v in counts().items()},
              "peeled": rec_conv2d_fused.peeled - before[1]})

    # m1 at 640^2: each stage-0 mixer peels level 4 of a 160^2 plane (C = 48, k = 5):
    # the down conv (bf16 -> f32 80^2) and, after K1's inner pyramid, the
    # upsample-add-conv (bf16 160^2 + f32 80^2 -> bf16); batch 2 as in the model phase;
    # then COCO's 200x334 plane's down conv in bf16 (an odd coarse width, 167: scalar
    # stores), checked only
    x = torch.randn(2, 48, 160, 160, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(48, 1, 5, 5, generator=gen) / 5).cuda()
    inner = torch.randn(2, 48, 80, 80, generator=gen).cuda()
    coco = torch.randn(2, 48, 200, 334, generator=gen).to("cuda", torch.bfloat16)
    total, max_abs_err = {"kernel_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}, 0.0
    for step, xs, stride, up in (("down", x, 2, None), ("up_add_conv", x, 1, inner),
                                 ("down", coco, 2, None)):
        for mode in ("bilinear", "nearest") if up is not None else ("bilinear",):
            kw = dict(stride=stride, up=up, mode=mode)
            got = rec_conv2d_level(xs, w, **kw)
            same_bits = all(torch.equal(rec_conv2d_level(xs, w, **kw), got) for _ in range(2))
            if not same_bits:
                raise AssertionError(f"level kernel {step} {mode} at {list(xs.shape)}: runs "
                                     "differ")
            out_dtype = got.dtype
            got, want = got.float(), rec_conv2d_level_plain(xs, w, **kw).float()
            # the plain version in fp32 before its one rounding, as the kernel
            want32 = rec_conv2d_level_plain(xs.float(), w, **kw)
            torch.cuda.synchronize()
            scale = want32.abs().max().item()
            err = (got - want32).abs().max().item()
            tol = (2e-5 if out_dtype == torch.float32 else 1e-2) * scale
            if not err <= tol:
                raise AssertionError(f"level kernel {step} {mode} mismatch: {err} > {tol}")
            rec = {"phase": "level_kernel", "step": step, "mode": mode if up is not None else None,
                   "x": list(xs.shape), "x_dtype": "bf16", "out": list(got.shape),
                   "out_dtype": str(out_dtype).removeprefix("torch."),
                   "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
                   "same_bits_on_3_runs": same_bits,
                   "max_abs_diff_vs_plain_rounded": (got - want).abs().max().item(),
                   "registers": recconv_cuda.level_kernel_attributes(5, stride,
                                                                     torch.bfloat16)}
            if mode == "bilinear" and xs is x:  # the 640^2 model's mode: its time and bound
                max_abs_err = max(max_abs_err, err)
                times = time_pair(lambda: rec_conv2d_level(x, w, **kw),
                                  lambda: rec_conv2d_level_plain(x, w, **kw))
                if up is None:  # one PyTorch call computes the down conv
                    times["library_ms"] = device_ms(lambda: F.conv2d(
                        x.float(), w, stride=2, padding=2, groups=48))
                nbytes, flops = level_work(2, 48, 160, 160, 5, stride, up is not None, 2,
                                           out_dtype.itemsize)
                bms, by = bound(nbytes, flops)
                rec.update(batch_2_bf16=dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                             flops=flops))
                for key, val in (("kernel_ms", times["kernel_ms"]),
                                 ("plain_ms", times["plain_ms"]), ("bytes", nbytes),
                                 ("flops", flops)):
                    total[key] += 3 * val  # 3 peeled mixers a forward
            emit(rec)
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["flops"])
    return total, max_abs_err


def attention_work(b, heads, n, d, dv, elem_bytes):
    """(bytes, flops) the linear-attention function needs: q, k, v read and out
    written once; per head 2*N*D*DV for k^T v and as many for q kv, N*D for ksum,
    2*N*D for q.ksum and N*DV divisions."""
    nbytes = elem_bytes * b * heads * n * (2 * d + 2 * dv)
    flops = b * heads * (4 * n * d * dv + 3 * n * d + n * dv)
    return nbytes, flops


def phase_attention():
    """K2 against its plain version through both entries; times at a1's shapes."""
    gen = torch.Generator().manual_seed(5)

    def inputs(b, heads, side, d, dv, dtype, shift=0):
        # elu(x)+1 features are positive, as tests/test_pallas.py draws q and k; with
        # a shift, every head starts `shift` planes past a tensor's start
        qk = torch.randn(b, shift + 2 * heads * d, side, side, generator=gen).abs() + 0.1
        v = torch.randn(b, shift + heads * dv, side, side, generator=gen)
        return qk.to("cuda", dtype)[:, shift:], v.to("cuda", dtype)[:, shift:]

    def shifted(t, shift):  # t's values in a buffer whose planes start `shift` earlier
        b, c, h, w = t.shape
        buf = torch.empty(b, shift + c, h, w, dtype=t.dtype, device=t.device)
        return buf[:, shift:].copy_(t)

    def heads_of(x, heads, shift=0):  # (B, nh*D, H, W) -> (B*nh, N, D), one span per head
        b, c, h, w = x.shape
        rows = x.reshape(b * heads, c // heads, h * w).transpose(1, 2)
        flat = torch.empty(shift + rows.numel(), dtype=x.dtype, device=x.device)
        return flat[shift:].view(rows.shape).copy_(rows)  # `shift` elements off alignment

    # tests/test_pallas.py:29-34's (BH, N, D, DV) as (batch, heads, side, D, DV), then
    # a1's four attention shapes at batch 8 (checked) and 256 (timed), then heads that
    # start off 16-byte alignment (one plane of 49 positions; 3 elements) and N = 1
    cases = [(1, 2, 4, 32, 32, 1, 0), (2, 2, 8, 64, 64, 1, 0), (1, 2, 7, 20, 20, 1, 0),
             (1, 2, 14, 20, 40, 1, 0)]
    cases += [(8, nh, side, A1_HEAD_DIM, A1_HEAD_DIM, var, 0)
              for nh, side, _, var in A1_ATTENTION.values()]
    cases += [(4, 8, 7, A1_HEAD_DIM, A1_HEAD_DIM, 1, 1), (4, 3, 1, A1_HEAD_DIM, 40, 1, 0)]
    per_stage, max_abs_err = {}, 0.0
    for b, nh, side, d, dv, variant, shift in cases:
        qk, v = inputs(b, nh, side, d, dv, torch.float32, shift)
        q, k = qk[:, : nh * d], qk[:, nh * d:]
        n = side * side
        rec = {"phase": "attention", "batch": b, "heads": nh, "n": n, "d": d, "dv": dv,
               "head_shift": shift,
               "launch": {f"{dt}_{lay}": attention_cuda.launch_config(n, d, dv, eb, lay)._asdict()
                          for dt, eb in (("bf16", 2), ("f32", 4)) for lay in ("n", "d")}}
        for cfg in rec["launch"].values():
            del cfg["geometry"]
        for dtype in (torch.float32, torch.bfloat16):
            qkx, vx = qk.to(dtype), v.to(dtype)
            qx, kx = q.to(dtype), k.to(dtype)
            if shift:  # the casts copied: keep every head off alignment
                qkx, vx = (shifted(t, shift) for t in (qkx, vx))
                qx, kx = qkx[:, : nh * d], qkx[:, nh * d:]
            # the plain version in f32 on the same (rounded) values
            want = linear_attention_nchw_plain(qkx.float(), vx.float(), nh)
            want_bh = linear_attention_kv_first(*(heads_of(t.float(), nh) for t in (qx, kx, vx)))
            got = linear_attention_nchw(qkx, vx, nh, variant=variant).float()
            got_bh = linear_attention_fused(
                *(heads_of(t, nh, 3 * (shift > 0)) for t in (qx, kx, vx))).float()
            torch.cuda.synchronize()
            for entry, g, w in (("nchw", got, want), ("bh", got_bh, want_bh)):
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                if dtype == torch.float32:
                    ok = bool(((g - w).abs() <= 1e-3 + 1e-3 * w.abs()).all())
                else:
                    ok = err <= 1e-2 * scale
                key = f"{'f32' if dtype == torch.float32 else 'bf16'}_{entry}"
                rec[f"{key}_max_abs_err"], rec[f"{key}_max_abs_ref"] = err, scale
                if not ok:
                    raise AssertionError(f"{key} attention kernel mismatch at "
                                         f"{(b, nh, side, d, dv, shift)}: {err} (max|ref| {scale})")
        stage = next((st for st, (h, sd, _, _) in A1_ATTENTION.items()
                      if (h, sd, d, dv) == (nh, side, A1_HEAD_DIM, A1_HEAD_DIM) and b == 8),
                     None)
        if stage is not None:
            max_abs_err = max(max_abs_err, rec["bf16_nchw_max_abs_err"],
                              rec["bf16_bh_max_abs_err"])
            # timing at the main path's size: batch 256, bf16, the model's entry
            qkt, vt = inputs(256, nh, side, d, dv, torch.bfloat16)
            times = time_pair(
                lambda: linear_attention_nchw(qkt, vt, nh, variant=variant),
                lambda: linear_attention_nchw_plain(qkt, vt, nh, variant=variant))
            nbytes, flops = attention_work(256, nh, side * side, d, dv, 2)
            bms, by = bound(nbytes, flops)
            per_stage[stage] = dict(times, bytes=nbytes, flops=flops)
            rec.update(stage=stage, variant=variant,
                       batch_256_bf16=dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                           flops=flops))
        emit(rec)
    emit({"phase": "attention_kernel", **{
        str(dt).removeprefix("torch."): attention_cuda.kernel_attributes(dt)
        for dt in (torch.float32, torch.bfloat16)}})
    return per_stage, max_abs_err


def attention_bwd_work(b, heads, n, d, dv, elem_bytes):
    """(bytes, flops) the linear-attention gradient needs from q, k, v and g: q, k, v
    and g read and dq, dk and dv written once; the fp32 operations of its three
    passes, per head 2*N*D*DV for each of k^T v, kv g_n, q^T a, dKV v_n and dKV^T k_n,
    and 9*N*D + N*DV for the sums, the normaliser's dots and the scalings."""
    nbytes = elem_bytes * b * heads * n * (4 * d + 3 * dv)
    flops = b * heads * (10 * n * d * dv + 9 * n * d + n * dv)
    return nbytes, flops


def _check_attention_grads(got, want, dtype, what):
    """Each of dq, dk, dv against the plain version in f32 on the same values: f32
    within 2e-5 max|ref| (the RecConv2d backward's bound), bf16 within 1e-2 max|ref|.
    A gradient that is 0 in exact arithmetic (dq and dk at N = 1, where out = v)
    holds rounding noise on both sides: under 1e-5. Returns the max errors and each
    over its max|ref| (None for a zero gradient)."""
    errs, rels = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        if scale < 1e-5:
            ok = a.abs().max().item() < 1e-5
        else:
            ok = err <= (2e-5 if dtype == torch.float32 else 1e-2) * scale
        if not ok:
            raise AssertionError(f"attention backward {name} mismatch at {what}: {err} "
                                 f"(max|ref| {scale})")
        errs[name], rels[name] = err, (err / scale if scale >= 1e-5 else None)
    return errs, rels


def phase_attention_backward():
    """K2' (the linear-attention backward kernel) against its plain version (autograd
    over the kv-first form in fp32, on the same values) through both entries: the
    (BH, N, D) one (d-fastest heads) and the model's NCHW one (n-fastest heads, q and
    k the halves of one tensor); the same bits on three runs; each shape's launch
    configuration and the kernel's registers; device times at a1's training shapes
    (batch 128, bf16, the NCHW entry) beside their bound and the plain version's."""
    gen = torch.Generator().manual_seed(9)

    def inputs(bh, n, d, dv):
        q = torch.randn(bh, n, d, generator=gen).abs() + 0.1  # elu(x)+1 features
        k = torch.randn(bh, n, d, generator=gen).abs() + 0.1
        v, g = torch.randn(bh, n, dv, generator=gen), torch.randn(bh, n, dv, generator=gen)
        return q, k, v, g

    def shifted(t, shift):  # t's values, `shift` elements past a buffer's start
        flat = torch.empty(shift + t.numel(), dtype=t.dtype, device=t.device)
        return flat[shift:].view(t.shape).copy_(t)

    def nchw(ts, nh, shift):  # (B*nh, N, R) -> (B, nh*R, 1, N), planes `shift` late
        bh, n, r = ts.shape
        buf = torch.empty(bh // nh, shift + nh * r, 1, n, dtype=ts.dtype, device=ts.device)
        return buf[:, shift:].copy_(ts.transpose(1, 2).reshape(bh // nh, nh * r, 1, n))

    def heads(t, nh, r):  # (B, nh*R, 1, N) -> (B*nh, N, R)
        return t.reshape(t.shape[0] * nh, r, t.shape[-1]).transpose(1, 2)

    def nchw_entry(q, k, v, g, nh, shift=0):
        d, dv = q.shape[-1], v.shape[-1]
        qk = torch.cat([nchw(q, nh, 0), nchw(k, nh, 0)], dim=1)
        if shift:
            qk = nchw(heads(qk, 1, 2 * nh * d), 1, shift)
        dqk, dvn = linear_attention_nchw_backward(qk, nchw(v, nh, shift), nchw(g, nh, shift), nh)
        return heads(dqk[:, : nh * d], nh, d), heads(dqk[:, nh * d:], nh, d), heads(dvn, nh, dv)

    # (BH, N, D, DV, heads a batch row, shift): tests/test_pallas.py:29-34's shapes; a1's
    # four training shapes at batch 128; DV != D (the L family's LA3); D = DV = 128;
    # heads off 16-byte alignment; N = 1; a packed block (2 and 4 heads of 128 and 64
    # threads) and a cluster's last slice (780 = 7 * 98 + 94) partly filled
    cases = [(2, 16, 32, 32, 2, 0), (4, 64, 64, 64, 2, 0), (2, 49, 20, 20, 2, 0),
             (2, 196, 20, 40, 2, 0)]
    cases += [(128 * nh, side * side, A1_HEAD_DIM, A1_HEAD_DIM, nh, 0)
              for nh, side, _, _ in A1_ATTENTION.values()]
    cases += [(16, 49, 12, 24, 4, 0), (4, 784, 128, 128, 2, 0), (12, 49, 24, 40, 3, 3),
              (6, 1, 24, 40, 3, 0), (3, 49, 24, 24, 3, 0), (5, 16, 24, 24, 5, 0),
              (6, 780, 24, 24, 2, 0)]
    per_stage, max_abs_err = {}, 0.0
    for bh, n, d, dv, nh, shift in cases:
        rec = {"phase": "attention_backward", "bh": bh, "n": n, "d": d, "dv": dv,
               "heads": nh, "head_shift": shift, "launch": {}}
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for lay in ("n", "d"):
                cfg = attention_bwd_cuda.launch_config(n, d, dv, dtype.itemsize, lay)
                rec["launch"][f"{dt}_{lay}"] = {
                    **{key: val for key, val in cfg._asdict().items() if key != "geometry"},
                    **attention_bwd_cuda.kernel_attributes(dtype, cfg.route),
                    "resident_blocks": attention_bwd_cuda.resident_blocks(cfg, dtype)}
        base = inputs(bh, n, d, dv)
        for dtype in (torch.float32, torch.bfloat16):
            key = "f32" if dtype == torch.float32 else "bf16"
            q, k, v, g = (t.to("cuda", dtype) for t in base)
            want = linear_attention_backward_plain(q.float(), k.float(), v.float(), g.float())
            got_d = linear_attention_backward(*(shifted(t, shift) for t in (q, k, v, g)))
            runs = [nchw_entry(q, k, v, g, nh, shift) for _ in range(3)]
            torch.cuda.synchronize()
            what = (bh, n, d, dv, shift, key)
            for lay, got in (("d", got_d), ("n", runs[0])):
                rec[f"{key}_{lay}_max_abs_err"], rec[f"{key}_{lay}_err_over_max_ref"] = (
                    _check_attention_grads(got, want, dtype, what))
            if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0])):
                raise AssertionError(f"attention backward: not the same bits on 3 runs at {what}")
            rec[f"{key}_same_bits_3_runs"] = True
        stage = next((st for st, (h, sd, _, _) in A1_ATTENTION.items()
                      if (bh, n, d, dv) == (128 * h, sd * sd, A1_HEAD_DIM, A1_HEAD_DIM)), None)
        if stage is not None:
            max_abs_err = max(max_abs_err, *rec["bf16_n_max_abs_err"].values())
            # timing at the train step's size: batch 128, bf16, the model's NCHW entry
            q, k, v, g = (t.to("cuda", torch.bfloat16) for t in base)
            qk = torch.cat([nchw(q, nh, 0), nchw(k, nh, 0)], dim=1)
            vn, gn = nchw(v, nh, 0), nchw(g, nh, 0)
            # device time by CUDA events around calls queued behind other work: the
            # profiler has listed only some of this kernel's launches in a run (0.4 of
            # them), so its time and launch count are printed beside
            call = lambda: linear_attention_nchw_backward(qk, vn, gn, nh)  # noqa: E731
            seen = [t for t in trace(call, iters=10) if "linear_attention_bwd_" in t["name"]]
            # as the train step finds its inputs: L2 (50 MB) flushed before each call by
            # writing 96 MB; the flush's own time taken off
            flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
            times = {"kernel_ms": queued_ms(call),
                     "kernel_cold_l2_ms": (queued_ms(lambda: (flush.zero_(), call()))
                                           - queued_ms(flush.zero_)),
                     "plain_ms": device_ms(
                         lambda: linear_attention_backward_plain(q, k, v, g), iters=3),
                     "profiler_kernel_ms": sum(t["ms"] for t in seen),
                     "profiler_launches_per_call": sum(t["launches"] for t in seen)}
            del flush
            nbytes, flops = attention_bwd_work(128, nh, n, d, dv, 2)
            bms, by = bound(nbytes, flops)
            per_stage[stage] = dict(times, bytes=nbytes, flops=flops)
            rec.update(stage=stage, batch_128_bf16=dict(times, bound_ms=bms, bound_by=by,
                                                        bytes=nbytes, flops=flops,
                                                        library_ms=None))
        emit(rec)
    emit({"phase": "attention_backward_kernel", **{
        f"{str(dt).removeprefix('torch.')}_{route}": attention_bwd_cuda.kernel_attributes(dt, route)
        for dt in (torch.float32, torch.bfloat16) for route in ("packed", "tiled")}})
    total = {key: sum(A1_ATTENTION[st][2] * per_stage[st][key] for st in per_stage)
             for key in ("kernel_ms", "kernel_cold_l2_ms", "profiler_kernel_ms", "plain_ms",
                         "bytes", "flops")}
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["flops"])
    emit({"phase": "attention_backward_step", "calls": 23, **total})
    return total, max_abs_err


def _l_inputs(gen, b, side, d, dv, vc, dtype):
    """One head per image: qk (B, 2D, H, W) of elu(x)+1-like values and v (B, DV, H,
    W), a channel slice of a (B, vc, H, W) tensor where vc (LA3), else its own."""
    qk = torch.randn(b, 2 * d, side, side, generator=gen).abs() + 0.1
    wide = torch.randn(b, vc or dv, side, side, generator=gen)
    v = wide.to("cuda", dtype)[:, :dv]
    if vc and not (v.stride(0) == vc * side * side and not v.is_contiguous()):
        raise AssertionError(f"v is not a channel slice: strides {v.stride()}")
    return qk.to("cuda", dtype), v


def _l_views_in_place(qk, v):
    """The NCHW entry's views of v are v's memory (no copy), one span a head."""
    q4, k4, v4, _ = _nchw_views(qk, v, 1)
    if v4.data_ptr() != v.data_ptr() or attention_cuda.head_layout(q4, k4, v4) != "n":
        raise AssertionError("the NCHW entry does not view v in place")


def _check_k2_l(gen, key, b, dtype):
    """K2 at one L shape, batch ``b``, through the model's NCHW entry (the slice read
    in place) and the (BH, N, D) entry: f32 within 1e-3 + 1e-3 |ref|, bf16 within
    1e-2 max|ref| of the plain version in f32 on the same values, the same bits on
    three runs. Returns the errors and the NCHW inputs."""
    side, d, dv, variant, vc = key
    n, dt = side * side, "f32" if dtype == torch.float32 else "bf16"
    qk, v = _l_inputs(gen, b, side, d, dv, vc, dtype)
    _l_views_in_place(qk, v)
    want = linear_attention_nchw_plain(qk.float(), v.float(), 1, variant=variant)
    runs = [linear_attention_nchw(qk, v, 1, variant=variant) for _ in range(3)]
    rows = [t.float().reshape(b, t.shape[1], n).transpose(1, 2).contiguous().to(dtype)
            for t in (qk[:, :d], qk[:, d:], v)]
    want_bh = linear_attention_kv_first(*(t.float() for t in rows))
    got_bh = linear_attention_fused(*rows).float()
    torch.cuda.synchronize()
    if not all(torch.equal(r, runs[0]) for r in runs[1:]):
        raise AssertionError(f"attention_l: not the same bits on 3 runs at {key} {dt} "
                             f"batch {b}")
    out = {f"{dt}_same_bits_3_runs": True}
    for entry, g, w in (("nchw", runs[0].float(), want), ("bh", got_bh, want_bh)):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        ok = (bool(((g - w).abs() <= 1e-3 + 1e-3 * w.abs()).all())
              if dtype == torch.float32 else err <= 1e-2 * scale)
        out[f"{dt}_{entry}_max_abs_err"], out[f"{dt}_{entry}_max_abs_ref"] = err, scale
        if not ok:
            raise AssertionError(f"attention_l {dt} {entry} mismatch at {key} batch {b}: "
                                 f"{err} (max|ref| {scale})")
    return out, (qk, v)


def phase_attention_l():
    """K2 at the L family's shapes (``L_ATTENTION``: one head per image, D up to 96,
    DV != D in LA3, whose v is a channel slice of the block's input), checked by
    ``_check_k2_l`` in f32 and bf16 at batch 8 and at batch 256, the serving path's
    size; each shape's launch configuration; device times at batch 256, bf16, on the
    checked inputs, beside the bound and the plain version, and their sums over each
    L model's forward. K2 must not lose to the plain version in CUDA events around
    calls queued behind other work (the profiler has listed half of the plain
    version's kernels in a long process)."""
    gen = torch.Generator().manual_seed(13)
    per_shape, max_abs_err = {}, 0.0
    for key, uses in L_ATTENTION.items():
        side, d, dv, variant, vc = key
        n = side * side
        rec = {"phase": "attention_l", "n": n, "d": d, "dv": dv, "variant": variant,
               "v_channel_slice_of": vc, "launches_per_forward": uses,
               "launch": {f"{dt}_{lay}": {k: v for k, v in attention_cuda.launch_config(
                   n, d, dv, eb, lay)._asdict().items() if k != "geometry"}
                   for dt, eb in (("bf16", 2), ("f32", 4)) for lay in ("n", "d")},
               "batch_256_checks": {}}
        for dtype in (torch.float32, torch.bfloat16):
            rec.update(_check_k2_l(gen, key, 8, dtype)[0])
            errs, (qkt, vt) = _check_k2_l(gen, key, 256, dtype)
            rec["batch_256_checks"].update(errs)
        max_abs_err = max(max_abs_err, rec["bf16_nchw_max_abs_err"], rec["bf16_bh_max_abs_err"],
                          rec["batch_256_checks"]["bf16_nchw_max_abs_err"])
        # timing at the serving path's size on the bf16 inputs just checked
        kernel = lambda: linear_attention_nchw(qkt, vt, 1, variant=variant)  # noqa: E731
        plain = lambda: linear_attention_nchw_plain(qkt, vt, 1, variant=variant)  # noqa: E731
        times = dict(time_pair(kernel, plain), kernel_queued_ms=queued_ms(kernel),
                     plain_queued_ms=queued_ms(plain, iters=10))
        nbytes, flops = attention_work(256, 1, n, d, dv, 2)
        bms, by = bound(nbytes, flops)
        per_shape[key] = dict(times, bytes=nbytes, flops=flops)
        rec["batch_256_bf16"] = dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                     flops=flops, library_ms=None,
                                     kernel_over_plain=times["kernel_queued_ms"]
                                     / times["plain_queued_ms"])
        emit(rec)
        if not times["kernel_queued_ms"] <= times["plain_queued_ms"]:
            raise AssertionError(f"attention_l: K2 slower than its plain version at {key}: "
                                 f"{times}")
    totals = {}
    for name in L_MODELS:
        table = {key: (None, None, uses[name]) for key, uses in L_ATTENTION.items()
                 if name in uses}
        totals[name] = forward_totals(per_shape, table)
        totals[name].update({k: sum(uses * per_shape[key][k] for key, (_, _, uses)
                                    in table.items())
                             for k in ("kernel_queued_ms", "plain_queued_ms")})
        emit({"phase": "attention_l_forward", "model": name, "launches": MIXERS[name],
              **totals[name]})
    return totals, max_abs_err


def phase_attention_backward_l():
    """K2' at the L family's shapes (one head per image), through the model's NCHW
    entry with LA3's v a channel slice read in place: each gradient against the plain
    version in f32 on the same values (f32 within 2e-5 max|ref|, bf16 within 1e-2
    max|ref|), the same bits on three runs, at batch 16 and, at recnext_t's shapes,
    at batch 128, the train step's size; each shape's launch configuration; device
    times at recnext_t's shapes at batch 128, bf16, on the checked inputs (CUDA
    events around queued calls, as the a1 phase times them) beside bound and plain,
    and their sum over one recnext_t train step's calls."""
    gen = torch.Generator().manual_seed(14)

    def rows(t, r):  # (B, R, H, W) -> (B, N, R)
        return t.reshape(t.shape[0], r, -1).transpose(1, 2)

    def check(key, b, dtype, dt):
        side, d, dv, _, vc = key
        qk, v = _l_inputs(gen, b, side, d, dv, vc, dtype)
        g = torch.randn(b, dv, side, side, generator=gen).to("cuda", dtype)
        _l_views_in_place(qk, v)
        want = linear_attention_backward_plain(
            *(rows(t.float(), r) for t, r in ((qk[:, :d], d), (qk[:, d:], d), (v, dv),
                                              (g, dv))))
        runs = [linear_attention_nchw_backward(qk, v, g, 1) for _ in range(3)]
        torch.cuda.synchronize()
        dqk, dvn = runs[0]
        got = (rows(dqk[:, :d], d), rows(dqk[:, d:], d), rows(dvn, dv))
        errs, rels = _check_attention_grads(got, want, dtype, (key, dt, b))
        if not all(torch.equal(x, y) for run in runs[1:] for x, y in zip(run, runs[0])):
            raise AssertionError(f"attention_backward_l: not the same bits on 3 runs "
                                 f"at {key} {dt} batch {b}")
        return {f"{dt}_max_abs_err": errs, f"{dt}_err_over_max_ref": rels,
                f"{dt}_same_bits_3_runs": True}, (qk, v, g)

    per_shape, max_abs_err = {}, 0.0
    for key, uses in L_ATTENTION.items():
        side, d, dv, _, vc = key
        n = side * side
        rec = {"phase": "attention_backward_l", "n": n, "d": d, "dv": dv,
               "v_channel_slice_of": vc, "calls_per_step": uses, "launch": {}}
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            cfg = attention_bwd_cuda.launch_config(n, d, dv, dtype.itemsize, "n")
            rec["launch"][dt] = {
                **{k: v for k, v in cfg._asdict().items() if k != "geometry"},
                "resident_blocks": attention_bwd_cuda.resident_blocks(cfg, dtype)}
        timed = "recnext_t" in uses
        if timed:
            rec["batch_128_checks"] = {}
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            rec.update(check(key, 16, dtype, dt)[0])
            if timed:
                errs, (qk, v, g) = check(key, 128, dtype, dt)
                rec["batch_128_checks"].update(errs)
        max_abs_err = max(max_abs_err, *rec["bf16_max_abs_err"].values())
        if timed:  # timing at the train step's size on the bf16 inputs just checked
            max_abs_err = max(max_abs_err, *rec["batch_128_checks"]["bf16_max_abs_err"].values())
            call = lambda: linear_attention_nchw_backward(qk, v, g, 1)  # noqa: E731
            q3, k3, v3, g3 = (rows(t, r).contiguous() for t, r in (
                (qk[:, :d], d), (qk[:, d:], d), (v, dv), (g, dv)))
            times = {"kernel_ms": queued_ms(call),
                     "plain_ms": device_ms(
                         lambda: linear_attention_backward_plain(q3, k3, v3, g3), iters=5)}
            nbytes, flops = attention_bwd_work(128, 1, n, d, dv, 2)
            bms, by = bound(nbytes, flops)
            per_shape[key] = dict(times, bytes=nbytes, flops=flops)
            rec["batch_128_bf16"] = dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                         flops=flops, library_ms=None)
        emit(rec)
    total = {k: sum(L_ATTENTION[key]["recnext_t"] * per_shape[key][k] for key in per_shape)
             for k in ("kernel_ms", "plain_ms", "bytes", "flops")}
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["flops"])
    emit({"phase": "attention_backward_l_step", "model": "recnext_t",
          "calls": MIXERS["recnext_t"], **total})
    return total, max_abs_err


def calibrated(name, **overrides):
    """``name`` with seeded weights and non-trivial BN: affine drawn from the
    generator, running statistics those of one random batch."""
    gen = torch.Generator().manual_seed(1)
    model = create_model(name, device="cuda", generator=gen, **overrides)
    bns = [m for m in model.modules()
           if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(1 + 0.2 * torch.randn(bn.num_features, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(bn.num_features, generator=gen))
            bn.reset_running_stats()
            bn.momentum = None  # cumulative: running stats = this batch's
        model.train()
        model(torch.randn(32, 3, 224, 224, generator=gen).cuda())
    return model.eval()


def plain_path(model):
    """Route every mixer that has a kernel through its plain version (until restored)."""
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    for m in mixers:
        m.forward = m.forward_plain
    return lambda: [m.__dict__.pop("forward") for m in mixers]


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def phase_model(name, *, side=224, batch=8, peeled=0, level_launches=0, **overrides):
    """Fused ``name`` (with ``overrides``) at ``batch`` x ``side``^2 against the unfused
    f32 plain path: its logits, and its kernel launches (and K1's peels) per forward."""
    expected = dict(EXPECTED[name], rec_conv2d_level=level_launches)
    unfused = calibrated(name, **overrides)
    fused_sd = fuse_params(unfused.state_dict())
    x = torch.randn(batch, 3, side, side, generator=torch.Generator().manual_seed(2)).cuda()
    out = {"phase": "model", "model": name, "overrides": overrides,
           "input": [batch, 3, side, side]}
    with torch.inference_mode():
        restore = plain_path(unfused)
        ref = unfused(x).float()  # unfused f32, plain path: the reference
        restore()
        for label, dtype, tol_ref, tol_plain in (
                ("f32", torch.float32, 1e-3, 1e-4),
                # bf16 keeps 8 bits: ~100 layers each rounding at 2^-9 drift by a
                # few percent of the logits' scale, and the max over 8k logits more
                ("bf16", torch.bfloat16, 1e-1, 1e-1)):
            model = create_model(name, fused=True, device="cuda", dtype=dtype, **overrides)
            model.load_state_dict(fused_sd, strict=True)
            xin = x.to(dtype)
            before, peels = counts(), rec_conv2d_fused.peeled
            got = model(xin).float()
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in counts().items()}
            peels = rec_conv2d_fused.peeled - peels
            if launches != expected or peels != peeled:
                raise AssertionError(f"{label}: kernel launches per {name} forward "
                                     f"{launches} and {peels} peeled, expected "
                                     f"{expected} and {peeled}")
            restore = plain_path(model)
            plain = model(xin).float()
            restore()
            if got.shape != (batch, 1000) or not torch.isfinite(got).all():
                raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
            scale = ref.abs().max().item()
            e_ref = (got - ref).abs().max().item()
            e_plain = (got - plain).abs().max().item()
            top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            top1_plain = (got.argmax(-1) == plain.argmax(-1)).float().mean().item()
            out[label] = {"launches_per_forward": launches, "peeled_per_forward": peels,
                          "max_abs_err_vs_unfused_f32": e_ref,
                          "max_abs_err_vs_plain_path": e_plain,
                          "max_abs_logit": scale, "top1_agree_vs_unfused_f32": top1,
                          "top1_agree_vs_plain_path": top1_plain,
                          "tol_vs_unfused_f32": tol_ref * scale,
                          "tol_vs_plain_path": tol_plain * scale}
            if not (e_ref <= tol_ref * scale and e_plain <= tol_plain * scale):
                raise AssertionError(f"{label} logits disagree: {out[label]}")
    emit(out)
    return unfused, out["bf16"]["launches_per_forward"]


def phase_serving(name, unfused):
    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as archive:
        publish_fused(name, unfused.state_dict(), archive)
        serving = ServingModel(archive, name, max_batch=8)
    serving.warmup()
    srv = make_server(serving, port=0, window_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/ping", timeout=30) as r:
            ping = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/models/{name}", timeout=30) as r:
            info = json.loads(r.read())
        if ping != {"status": "Healthy"} or info["model"] != name \
                or info["packed"] != (serving.cfg.family in ("m", "a")):
            raise AssertionError(f"bad /ping or /models answer: {ping} {info}")

        rng = np.random.default_rng(3)
        requests = [rng.normal(size=(3, 224, 224)).astype(np.float32) for _ in range(24)]
        results, latency, errors = {}, {}, []

        def client(ids):
            for i in ids:
                t0 = time.perf_counter()
                try:
                    results[i] = srv.batcher.submit(requests[i], timeout=300)
                except Exception as e:  # reported below; the phase fails
                    errors.append(repr(e))
                latency[i] = time.perf_counter() - t0

        batches0 = serving.batches_run
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        clients = [threading.Thread(target=client, args=(range(j, 24, 6),))
                   for j in range(6)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        launches = counts()  # ... and ends here
        batches = serving.batches_run - batches0
        if errors or len(results) != 24 or any(t.is_alive() for t in clients):
            raise AssertionError(f"serving failed: {len(results)}/24 answered, {errors[:3]}")
        want = {k: n * batches for k, n in EXPECTED[name].items()}
        if launches != want:
            raise AssertionError(f"kernel launches {launches} for {batches} batches, "
                                 f"expected {want}")
        worst = 0.0
        for i, arr in enumerate(requests):
            direct = serving.predict(arr[None])[0]
            worst = max(worst, float(np.abs(direct - results[i]).max()))
            if direct.argmax() != results[i].argmax():
                raise AssertionError(f"request {i}: served top-1 differs from predict")
        if not worst <= 1e-3:
            raise AssertionError(f"served probabilities differ from predict by {worst}")
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
    lat = sorted(latency.values())
    emit({"phase": "serving", "model": name, "requests_served": len(results),
          "batches_run": batches, "kernel_launches": launches,
          "p50_latency_ms": 1e3 * statistics.median(lat),
          "max_latency_ms": 1e3 * lat[-1], "max_abs_prob_diff_vs_predict": worst,
          "model_info": info})
    return serving, launches


def phase_throughput(name, model, kernel, kernel_sum_ms):
    """Fused ``name`` at batch 256 and batch 1: the kernel path, then (for scale only)
    the same model with its mixers on the plain version. For the kernel path, a
    profiler trace gives the device's busy time per forward (its idle share is the
    rest), the time of ``kernel`` (a CUDA function name) in it, and the kernels
    that take the most device time."""
    gen = torch.Generator().manual_seed(4)
    dtype = next(model.parameters()).dtype
    x256 = torch.randn(256, 3, 224, 224, generator=gen).to("cuda", dtype)
    x1 = x256[:1].contiguous()
    out = {"phase": "throughput", "model": name, "dtype": str(dtype), "fused": True}
    with torch.inference_mode():
        for path in ("kernel_path", "plain_path"):
            restore = plain_path(model) if path == "plain_path" else None
            plain = restore is not None  # timed for scale only: fewer calls
            ms256 = cuda_ms(lambda: model(x256), iters=5 if plain else 10, warmup=3)
            ms1 = cuda_ms(lambda: model(x1), iters=20 if plain else 50, warmup=5)
            out[path] = {"batch_256_ms": ms256, "images_per_s": 256 * 1e3 / ms256,
                         "batch_1_latency_ms": ms1}
            if restore:
                restore()
                continue
            for batch, x, ms in ((256, x256, ms256), (1, x1, ms1)):
                kernels = trace(lambda: model(x), iters=5 if batch == 256 else 10)
                busy = sum(k["ms"] for k in kernels)
                ours = sum(k["ms"] for k in kernels if kernel in k["name"])
                out[path][f"batch_{batch}_trace"] = {
                    "device_busy_ms": busy, "device_idle_share": 1 - busy / ms,
                    "kernel_ms": ours, "kernel_share_of_busy": ours / busy,
                    "top_kernels": kernels[:8]}
    # the kernel's 23 launches, each timed alone at its shape (device time), against
    # the forward
    out["kernel_sum_ms"] = kernel_sum_ms
    out["kernel_share"] = kernel_sum_ms / out["kernel_path"]["batch_256_ms"]
    emit(out)
    return out["kernel_path"]["images_per_s"]


def recconv_bwd_work(n, c, h, w, level, k, elem_bytes):
    """(bytes, flops) RecConv2d's gradient needs from x, the weights and g: x and g
    read and dx written once, the weights read and their gradients written once
    (fp32); and the fp32 operations: the forward's sums h recomputed from x (K1's
    work less its final conv), at level 0 the final conv's weight gradient and input
    gradient, at every level below the level conv's two and the down conv's two
    (2k^2 a output each), and 10 a fine output for each resize adjoint."""
    sizes = recconv_cuda.pyramid_sizes(h, w, level)
    area = [a * b for a, b in sizes]
    recompute = 2 * k * k * 2 * sum(area[1:]) + 10 * sum(area[:-1])
    backward = 4 * k * k * area[0] + 8 * k * k * sum(area[1:]) + 10 * sum(area[:-1])
    flops = n * c * (recompute + backward)
    nbytes = elem_bytes * 3 * n * c * h * w + 4 * 2 * (level + 2) * k * k * c
    return nbytes, flops


def _check_backward(x, ws, g, level, mode):
    """The backward kernel against its plain version (autograd over rec_conv2d in
    fp32, cuDNN TF32 off) on the same values: f32 dx within 2e-5 max|ref| and dW
    within 1e-4 max|ref| (a sum over N*H*W terms); bf16 within 1e-2 max|ref|."""
    got = rec_conv2d_backward(x, ws[0], ws[1:], g, level=level, mode=mode)
    want = rec_conv2d_backward_plain(x.float(), ws[0].float(), [t.float() for t in ws[1:]],
                                     g.float(), level=level, mode=mode)
    torch.cuda.synchronize()
    f32 = x.dtype == torch.float32
    out, worst = {}, 0.0
    for i, (a, b) in enumerate(zip([got[0], got[1], *got[2]], [want[0], want[1], *want[2]])):
        name = "dx" if i == 0 else f"dW{i - 1}"
        tol = (2e-5 if i == 0 else 1e-4) if f32 else 1e-2
        scale = b.abs().max().item()
        err = (a.float() - b).abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"backward kernel {name} mismatch at {tuple(x.shape)} "
                                 f"L{level} {mode} {x.dtype}: {err} > {tol} * {scale}")
        out[name] = err / scale
        worst = max(worst, err)
    return out, worst


def phase_backward():
    """The backward kernel at m1's four training shapes (batch 128), f32 and bf16,
    bilinear and nearest, against its plain version; device times at bf16 bilinear
    (the train step's), each shape's bound, its launch configuration and the kernel's
    registers."""
    gen = torch.Generator().manual_seed(7)
    per_shape, max_abs_err = {}, 0.0
    for level, (c, side, _) in M1_MIXERS.items():
        rec = {"phase": "backward", "shape": [128, c, side, side], "level": level,
               "launch": recconv_bwd_cuda.launch_config(side, side, level, 5)._asdict()}
        del rec["launch"]["geometry"]
        rec["launch"]["resident_blocks_per_sm"] = recconv_bwd_cuda.resident_blocks(
            side, side, level, 5, torch.bfloat16)
        x = torch.randn(128, c, side, side, generator=gen)
        g = torch.randn(128, c, side, side, generator=gen)
        ws = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(level + 2)]
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to("cuda", dtype), g.to("cuda", dtype)
            wd = [t.to("cuda", dtype) for t in ws]
            for mode in ("bilinear", "nearest"):
                errs, worst = _check_backward(xd, wd, gd, level, mode)
                key = f"{'f32' if dtype == torch.float32 else 'bf16'}_{mode}"
                rec[f"{key}_err_over_max_ref"] = errs
                if dtype == torch.bfloat16:
                    max_abs_err = max(max_abs_err, worst)
            if dtype == torch.bfloat16:
                times = {"kernel_ms": device_ms(
                             lambda: rec_conv2d_backward(xd, wd[0], wd[1:], gd, level=level),
                             iters=10),
                         "plain_ms": device_ms(
                             lambda: rec_conv2d_backward_plain(xd, wd[0], wd[1:], gd,
                                                               level=level), iters=3)}
                nbytes, flops = recconv_bwd_work(128, c, side, side, level, 5, 2)
                bms, by = bound(nbytes, flops)
                per_shape[level] = dict(times, bytes=nbytes, flops=flops)
                rec["batch_128_bf16"] = dict(times, bound_ms=bms, bound_by=by, bytes=nbytes,
                                             flops=flops, library_ms=None)
        rec["registers"] = {str(dt).removeprefix("torch."): recconv_bwd_cuda.kernel_attributes(
            5, dt) for dt in (torch.float32, torch.bfloat16)}
        emit(rec)
    total = {key: sum(M1_MIXERS[lv][2] * per_shape[lv][key] for lv in per_shape)
             for key in ("kernel_ms", "plain_ms", "bytes", "flops")}
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["flops"])
    return total, max_abs_err


def phase_train_grad(name="recnext_m1", side=224, batch=8, expected=None, peeled=0):
    """``name`` (recnext_m1, recnext_a1 or recnext_t) at full width and depth,
    ``side``^2, ``batch``, f32, in train mode: every parameter's gradient of the loss
    through the kernel path (the forward kernel and its backward in every mixer: K1
    and K1', or K2 and K2'; at 512^2 K1′'s peeled route in stage 0) against the plain
    path (autograd over forward_plain). The counts are set to 0 just before the kernel
    path and read just after: ``expected`` (by default MIXERS[name] of the forward
    kernel and of its backward, nothing else) and ``peeled`` backward calls that
    peeled.
    Tolerance 1e-3 max|ref| of each tensor: fp32 sums in another order, carried
    back through ~100 train-mode BatchNorms. A tensor whose exact gradient is 0 (a
    shift that a BatchNorm follows) holds rounding noise on both paths: its
    reference max is under 1e-6, and the kernel path's is held under 1e-5."""
    import copy

    gen = torch.Generator().manual_seed(8)
    model = create_model(name, device="cuda", generator=gen).train()
    x = torch.randn(batch, 3, side, side, generator=gen).cuda()
    y = torch.randint(0, 1000, (batch,), generator=gen).cuda()
    out = {"phase": "train_grad", "model": name, "input": [batch, 3, side, side]}
    fwd, bwd = TRAIN_KERNELS[name]
    expected = expected or dict.fromkeys(COUNTERS, 0) | {fwd: MIXERS[name], bwd: MIXERS[name]}
    grads = {}
    for path in ("kernel_path", "plain_path"):
        m = copy.deepcopy(model)
        restore = plain_path(m) if path == "plain_path" else None
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        rec_conv2d_backward.peeled = 0
        loss = train_loss(m, x, y, dtype=torch.float32)
        loss.backward()
        torch.cuda.synchronize()
        launches, peels = counts(), rec_conv2d_backward.peeled  # ... and ends here
        if restore:
            restore()
        want = expected if path == "kernel_path" else dict.fromkeys(COUNTERS, 0)
        want_peels = peeled if path == "kernel_path" else 0
        if launches != want or peels != want_peels:
            raise AssertionError(f"{path}: launches {launches} and {peels} peeled, expected "
                                 f"{want} and {want_peels}")
        grads[path] = {n: p.grad for n, p in m.named_parameters()}
        out[path] = {"loss": loss.item(), "launches": launches, "backward_peeled": peels}
    if not abs(out["kernel_path"]["loss"] - out["plain_path"]["loss"]) <= \
            1e-5 * abs(out["plain_path"]["loss"]):
        raise AssertionError(f"losses differ: {out}")
    worst, zero = (0.0, ""), 0
    for name, want in grads["plain_path"].items():
        got = grads["kernel_path"][name]
        scale = want.abs().max().item()
        if scale < 1e-6:
            zero += 1
            if not got.abs().max().item() < 1e-5:
                raise AssertionError(f"{name}: gradient {got.abs().max().item()} where the "
                                     f"plain path's is 0 ({scale})")
            continue
        ratio = (got - want).abs().max().item() / scale
        worst = max(worst, (ratio, name))
        if not ratio <= 1e-3:
            raise AssertionError(f"{name}: kernel-path gradient off by {ratio} max|ref|")
    out.update(parameters=len(grads["plain_path"]), zero_gradient_tensors=zero,
               worst_err_over_max_ref=worst[0], worst_parameter=worst[1], tol=1e-3)
    emit(out)
    return out["kernel_path"]["launches"]


def phase_train(name="recnext_m1", args=TRAIN_ARGS, keep=None):
    """The trainer, ``recnext_tpu_torch.train.main.main``, on the card with ``args``:
    ``name`` (recnext_m1 or recnext_t; recnext_a1 with hard distillation from a seeded
    regnety_160), FAKE, --simple-aug, 224^2, batch 64, 2 epochs of 3 steps, then a
    rerun to 3 epochs that resumes. Every count set to 0 just before the first run and
    read just after: MIXERS[name] launches of the model's forward kernel (K1 or K2)
    and as many calls of its backward (K1' or K2') per train step, as many
    forward-kernel launches per fused eval forward, nothing else (the teacher
    launches no kernel of the port). The last checkpoint is copied to ``keep`` where
    given."""
    import contextlib
    import io

    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    rec = {"phase": "train", "model": name, "args": args}
    fwd, bwd = TRAIN_KERNELS[name]
    mixers = MIXERS[name]
    with tempfile.TemporaryDirectory(dir=build) as run_dir:
        runs = []
        for epochs in (2, 3):
            for fn in COUNTERS.values():  # the main path starts here
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train_main.main(args + ["--epochs", str(epochs), "--output-dir", run_dir])
            torch.cuda.synchronize()
            launches = counts()  # ... and ends here
            text = buf.getvalue()
            ran = epochs - (2 if epochs == 3 else 0)
            steps = TRAIN_STEPS_PER_EPOCH * ran
            evals = EVAL_FORWARDS_PER_EPOCH * ran
            losses = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                      if ": loss " in line]
            stats = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
            per_step = {fwd: (launches[fwd] - mixers * evals) / steps,
                        bwd: launches[bwd] / steps}
            others = {k: v for k, v in launches.items() if k not in (fwd, bwd)}
            run = {"epochs": epochs, "seconds": time.perf_counter() - t0, "losses": losses,
                   "epoch_lines": stats, "launches": launches,
                   "launches_per_train_step": per_step,
                   "resumed": "auto-resumed at epoch 2" in text,
                   "checkpoints": sorted(p.name for p in (Path(run_dir) / "ckpt").iterdir())}
            runs.append(run)
            if (len(losses) != steps or not all(np.isfinite(losses))
                    or len(stats) != ran or not all(np.isfinite(s["train_loss"]) for s in stats)):
                raise AssertionError(f"train run to {epochs} epochs: {run}")
            if per_step != {fwd: mixers, bwd: mixers} or any(others.values()):
                raise AssertionError(f"train run to {epochs} epochs: launches {launches}")
            if run["resumed"] != (epochs == 3):
                raise AssertionError(f"train run to {epochs} epochs: resume {run['resumed']}")
        rec["runs"] = runs
        if keep is not None:  # the last checkpoint, and the log beside it
            keep.write_bytes((Path(run_dir) / "ckpt" / "epoch_0002.pt").read_bytes())
            keep.with_suffix(".log").write_text((Path(run_dir) / "log.txt").read_text())
    emit(rec)
    return runs[0]["launches"]


TRACE_KERNELS = {  # CUDA function names of each training path's kernels: (forward,
    # backward, ...)
    "recnext_m1": ("recconv_kernel", "recconv_bwd_kernel", "recconv_bwd_sum_kernel"),
    "recnext_a1": ("linear_attention_kernel", "linear_attention_bwd_"),  # K2' either route
    "recnext_t": ("linear_attention_kernel", "linear_attention_bwd_")}


def phase_train_throughput(name="recnext_m1", teacher=None, timed_s=TIMED_S):
    """bench.train_throughput(name, 128) with TIMED_REPEATS repeats of ``timed_s`` seconds
    (distilled from a seeded ``teacher`` where given), then a profiler trace of 2
    steps of the same step: the top kernels, the backward kernel's share and the
    device's idle share. The trace must list MIXERS[name] launches a step of each of
    the port's kernels."""
    step = bench.train_bench_step(name, 128, teacher=teacher)
    ips, batch, spread = bench.train_throughput(name, 128, repeats=TIMED_REPEATS,
                                                timed_s=timed_s, step=step)
    step_ms = batch / ips * 1e3
    kernels = trace(step[0], iters=2, warmup=1)
    busy = sum(k["ms"] for k in kernels)
    if busy > step_ms:  # the trace counts some device time twice: no idle share to give
        raise AssertionError(f"train_throughput: device busy {busy} ms in a step of "
                             f"{step_ms} ms")
    # no name of the tuple is a part of another, so a substring picks one kernel
    ours = {kn: sum(k["ms"] for k in kernels if kn in k["name"]) for kn in TRACE_KERNELS[name]}
    launches = {kn: sum(k["launches"] for k in kernels if kn in k["name"])
                for kn in TRACE_KERNELS[name]}
    if any(n != MIXERS[name] for n in launches.values()):  # each runs once a mixer
        raise AssertionError(f"train_throughput: the trace lists {launches} launches a "
                             f"step of the port's kernels, not {MIXERS[name]} each: it "
                             f"lost some, so its busy time and idle share would be wrong")
    emit({"phase": "train_throughput", "model": name, "teacher": teacher,
          "distillation": "hard" if teacher else "none", "batch": batch,
          "dtype": "bf16 compute, fp32 parameters", "images_per_s_median": ips,
          "spread": spread, "step_ms": step_ms, "device_busy_ms_per_step": busy,
          "device_idle_share": 1 - busy / step_ms,
          "kernel_ms_per_step": ours, "kernel_launches_per_step": launches,
          "backward_kernel_share_of_busy": sum(ours[kn] for kn in TRACE_KERNELS[name][1:])
          / busy,
          "top_kernels": kernels[:8]})
    return ips, busy


def level_bwd_work(kind, n, c, h, w, k, *, stride=1, up=False, add=False, in_bytes=4,
                   g_bytes=4, out_bytes=4):
    """(bytes, flops) of one peeled level's backward kernel, each input read and each
    output written once: ``dgrad`` reads g (the stride-``stride`` output of an h x w
    input; ``add`` the fp32 fine gradient) and writes dx, 2k^2 flops per element of g;
    ``wgrad`` reads x (and the fp32 coarse plane where ``up``, 10 flops a fine element
    to add its upsample) and g and writes the fp32 k x k gradients, 2k^2 flops per
    element of g; ``up_adjoint`` reads the fp32 fine gradient and writes the coarse
    one, 10 flops a fine element (the adjoint of three lerps)."""
    oh, ow = (h, w) if stride == 1 else ((h + 1) // 2, (w + 1) // 2)
    fine, coarse, out = n * c * h * w, n * c * ((h + 1) // 2) * ((w + 1) // 2), n * c * oh * ow
    if kind == "dgrad":
        return (g_bytes * out + 4 * c * k * k + (4 * fine if add else 0) + out_bytes * fine,
                2 * k * k * out + (fine if add else 0))
    if kind == "wgrad":
        return (in_bytes * fine + (4 * coarse if up else 0) + g_bytes * out + 4 * c * k * k,
                2 * k * k * out + (10 * fine if up else 0))
    return 4 * fine + 4 * coarse, 10 * fine


def _check_close(name, got, want, tol):
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{name}: {err} > {tol} * {scale}")
    return err, scale


def peeled_backward_launches(h, w, level, k):
    """The launches one ``rec_conv2d_backward`` call makes on an h x w plane that
    peels: per peeled level, the stride-2 level kernel for d and K1 for y (whose own
    forward peels its plane if it must, two level-kernel launches a peeled level), or
    the level kernel alone for y where the inner level is 0; KL′1 and KL′2 twice
    (stride 1 and stride 2) and KL′3 once; then K1′ once at the inner plane, or the
    level backward (KL′1, KL′2) where the inner level is 0."""
    peel = recconv_bwd_cuda.levels_to_peel_backward(h, w, level, k)
    sizes = recconv_cuda.pyramid_sizes(h, w, level)
    want = dict.fromkeys(("rec_conv2d", "rec_conv2d_level", "rec_conv2d_backward",
                          *LEVEL_BWD), 0)
    for i in range(peel):
        inner = level - 1 - i
        want["rec_conv2d_level"] += 1
        if inner == 0:
            want["rec_conv2d_level"] += 1
        else:
            want["rec_conv2d"] += 1
            want["rec_conv2d_level"] += 2 * recconv_cuda.levels_to_peel(*sizes[i + 1], inner,
                                                                        k, 4)
        want["rec_conv2d_level_dgrad"] += 2
        want["rec_conv2d_level_wgrad"] += 2
        want["rec_conv2d_up_adjoint"] += 1
    if level > peel:
        want["rec_conv2d_backward"] += 1
    else:
        want["rec_conv2d_level_dgrad"] += 1
        want["rec_conv2d_level_wgrad"] += 1
    return {name: n for name, n in want.items() if n}


def level_backward_cases(x, g, ws, gen, dtype):
    """KL′1-3's cases at the outer level of the plane of x (n, c, h, w), as a train step
    in ``dtype`` runs them: g and x in ``dtype``, the recomputed inner plane y, its
    gradient dd and dz fp32. Each case is (kernel, what, tolerance over max|ref|,
    kernel call, plain call, library call, (bytes, flops) or None where untimed, the
    instantiation's (kind, stride, dtypes) for its registers): the input gradient at
    stride 1 and 2, the weight gradient at stride 1 (z = x + up(y)) and 2, the up-step's
    adjoint, bilinear (timed) and nearest."""
    n, c, h, w = x.shape
    dh, dw_ = (h + 1) // 2, (w + 1) // 2
    eb = dtype.itemsize
    name = "f32" if dtype == torch.float32 else "bf16"
    xb, gb = x.to("cuda", dtype), g.to("cuda", dtype)
    w_l, w_down = ws[-1].cuda(), ws[0].cuda()
    y = torch.randn(n, c, dh, dw_, generator=gen).cuda()
    dd = torch.randn(n, c, dh, dw_, generator=gen).cuda()
    dz = torch.randn(n, c, h, w, generator=gen).cuda()
    z = xb.float() + resize(y, (h, w))  # the library call's input: z written out
    cgrad = torch.nn.grad
    up_bwd = {"bilinear": lambda t: torch.ops.aten.upsample_bilinear2d_backward(
                  t, [h, w], [n, c, dh, dw_], False),
              "nearest": lambda t: torch.ops.aten.upsample_nearest2d_backward(
                  t, [h, w], [n, c, dh, dw_])}
    return [
        ("rec_conv2d_level_dgrad", f"stride 1: dz = conv_L^T(g), {name} g -> f32", 2e-5,
         lambda: rec_conv2d_level_dgrad(gb, w_l, size=(h, w)),
         lambda: rec_conv2d_level_dgrad_plain(gb, w_l, size=(h, w)),
         lambda: cgrad.conv2d_input((n, c, h, w), w_l, gb.float(), padding=2, groups=c),
         level_bwd_work("dgrad", n, c, h, w, 5, g_bytes=eb),
         ("dgrad", 1, (dtype, torch.float32))),
        ("rec_conv2d_level_dgrad", f"stride 2: dx = dz + down^T(dd), f32 -> {name}",
         2e-5 if dtype == torch.float32 else 1e-2,
         lambda: rec_conv2d_level_dgrad(dd, w_down, size=(h, w), stride=2, add=dz,
                                        out_dtype=dtype),
         lambda: rec_conv2d_level_dgrad_plain(dd, w_down, size=(h, w), stride=2, add=dz),
         lambda: cgrad.conv2d_input((n, c, h, w), w_down, dd, stride=2, padding=2,
                                    groups=c) + dz,
         level_bwd_work("dgrad", n, c, h, w, 5, stride=2, add=True, out_bytes=eb),
         ("dgrad", 2, (torch.float32, dtype))),
        ("rec_conv2d_level_wgrad", f"stride 1: dW_L = sum (x + up(y)) * g, {name}", 1e-4,
         lambda: rec_conv2d_level_wgrad(xb, gb, k=5, up=y),
         lambda: rec_conv2d_level_wgrad_plain(xb, gb, k=5, up=y),
         lambda: cgrad.conv2d_weight(z, (c, 1, 5, 5), gb.float(), padding=2, groups=c),
         level_bwd_work("wgrad", n, c, h, w, 5, up=True, in_bytes=eb, g_bytes=eb),
         ("wgrad", 1, (dtype, dtype))),
        ("rec_conv2d_level_wgrad", "stride 2: dW_down += sum x *_2 dd", 1e-4,
         lambda: rec_conv2d_level_wgrad(xb, dd, k=5, stride=2),
         lambda: rec_conv2d_level_wgrad_plain(xb, dd, k=5, stride=2),
         lambda: cgrad.conv2d_weight(xb.float(), (c, 1, 5, 5), dd, stride=2, padding=2,
                                     groups=c),
         level_bwd_work("wgrad", n, c, h, w, 5, stride=2, in_bytes=eb),
         ("wgrad", 2, (dtype, torch.float32))),
        ("rec_conv2d_up_adjoint", "dy = up^T(dz), bilinear", 2e-5,
         lambda: rec_conv2d_up_adjoint(dz),
         lambda: rec_conv2d_up_adjoint_plain(dz),
         lambda: up_bwd["bilinear"](dz),
         level_bwd_work("up_adjoint", n, c, h, w, 5),
         ("up_adjoint", 1, (torch.float32, torch.float32))),
        ("rec_conv2d_up_adjoint", "dy = up^T(dz), nearest", 2e-5,
         lambda: rec_conv2d_up_adjoint(dz, mode="nearest"),
         lambda: rec_conv2d_up_adjoint_plain(dz, mode="nearest"),
         lambda: up_bwd["nearest"](dz), None, ("up_adjoint", 1, (torch.float32, torch.float32)))]


def level_backward_case(phase, case, shape):
    """One case of ``level_backward_cases``: the kernel against its plain version (its
    launch counted) and its own output on two more runs (the same bits), its library
    call's difference, the kernel's registers, and where the case has its work (the
    train step's mode) the kernel's, plain and library times (CUDA events around queued
    calls) beside the bound, and their ratio. Returns the phase line."""
    kernel, what, tol, run, plain, library, work, (kind, stride, dtypes) = case
    before = COUNTERS[kernel].launches
    got = run()
    if COUNTERS[kernel].launches != before + 1:
        raise AssertionError(f"{kernel} {what}: launches not counted")
    want = plain()
    err, scale = _check_close(f"{kernel} {what} at {shape}", got, want, tol)
    for _ in range(2):
        if not torch.equal(run(), got):
            raise AssertionError(f"{kernel} {what} at {shape}: runs differ")
    out = {"phase": phase, "kernel": kernel, "what": what, "shape": shape,
           "max_abs_err": err, "max_abs_ref": scale, "tol": tol * scale,
           "same_bits_on_3_runs": True,
           "library_max_abs_diff": (library().float() - want.float()).abs().max().item(),
           **level_bwd_cuda.kernel_attributes(kind, 5, stride, dtypes)}
    if work is not None:
        times = {"kernel_ms": queued_ms(run), "plain_ms": queued_ms(plain, iters=5),
                 "library_ms": queued_ms(library)}
        bms, by = bound(*work)
        out.update(times, bound_ms=bms, bound_by=by, bytes=work[0], flops=work[1],
                   over_bound=times["kernel_ms"] / bms)
    return out


def phase_large_plane_backward():
    """K1′'s peeled route on planes whose backward exceeds K1′'s shared memory, against
    the plain version; then each of the three level kernels alone, against its plain
    version, timed beside its bound, its plain version and one PyTorch call."""
    gen = torch.Generator().manual_seed(11)
    errs_by_kernel = dict.fromkeys(LEVEL_BWD, 0.0)
    step_totals = {}  # per kernel: sums over one m1 train step at 512^2, batch 2
    for n, c, h, w in LARGE_BWD:
        level = 4
        x = torch.randn(n, c, h, w, generator=gen)
        g = torch.randn(n, c, h, w, generator=gen)
        ws = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(level + 2)]
        peel = recconv_bwd_cuda.levels_to_peel_backward(h, w, level, 5)
        if peel != {(128, 128): 1, (200, 334): 2}[(h, w)]:
            raise AssertionError(f"{h}x{w} L{level}: {peel} levels peel")
        want_launches = peeled_backward_launches(h, w, level, 5)
        rec = {"phase": "large_plane_backward", "shape": [n, c, h, w], "level": level,
               "levels_peeled": peel, "launches_per_call": want_launches}
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to("cuda", dtype), g.to("cuda", dtype)
            wd = [t.to("cuda", dtype) for t in ws]
            for mode in ("bilinear", "nearest"):
                key = f"{'f32' if dtype == torch.float32 else 'bf16'}_{mode}"
                before, peels = counts(), rec_conv2d_backward.peeled
                errs, _ = _check_backward(xd, wd, gd, level, mode)
                rec[f"{key}_err_over_max_ref"] = errs
                got = {k: v - before[k] for k, v in counts().items() if v != before[k]}
                if rec_conv2d_backward.peeled - peels != 1 or got != want_launches:
                    raise AssertionError(f"{key}: {rec_conv2d_backward.peeled - peels} "
                                         f"peeled calls, launches {got}, want 1 and "
                                         f"{want_launches}")
                first = rec_conv2d_backward(xd, wd[0], wd[1:], gd, level=level, mode=mode)
                for _ in range(2):
                    again = rec_conv2d_backward(xd, wd[0], wd[1:], gd, level=level,
                                                mode=mode)
                    if not all(torch.equal(a, b) for a, b in zip(
                            [first[0], first[1], *first[2]], [again[0], again[1], *again[2]])):
                        raise AssertionError(f"{rec['shape']} {key}: runs differ")
                rec[f"{key}_same_bits_on_3_runs"] = True
        emit(rec)

        for case in level_backward_cases(x, g, ws, gen, torch.bfloat16):
            out = level_backward_case("level_backward_kernel", case, [n, c, h, w])
            errs_by_kernel[case[0]] = max(errs_by_kernel[case[0]], out["max_abs_err"])
            if "kernel_ms" in out and (n, c, h, w) == LARGE_BWD[0]:
                # 3 peeled mixers of m1's 512^2 step
                tot = step_totals.setdefault(case[0], dict.fromkeys(
                    ("kernel_ms", "plain_ms", "library_ms", "bytes", "flops"), 0.0))
                for key in tot:
                    tot[key] += 3 * out[key]
            emit(out)
    regs = {kind: level_bwd_cuda.kernel_attributes(kind, 5, stride, dts)
            for kind, stride, dts in (("dgrad", 1, (torch.bfloat16, torch.float32)),
                                      ("wgrad", 1, (torch.bfloat16, torch.bfloat16)),
                                      ("up_adjoint", 1, (torch.float32, torch.float32)))}
    emit({"phase": "level_backward_registers", "k": 5, **regs})
    for tot in step_totals.values():
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"])
    return step_totals, errs_by_kernel


def phase_finetune(checkpoint: Path, work_dir: Path):
    """The 384^2 finetune recipe through the trainer: recnext_m1 warm-started from
    ``checkpoint`` (the train phase's) and from a fused archive of its EMA weights onto
    100 classes, with --grad-accum 2 --remat --mesa 1.0 --mesa-start-ratio 0; each run
    with every count set to 0 just before it and read just after. Then validate.py
    --fused scores the finetuned checkpoint into a CSV, and the recipe's step is timed
    and traced at batch 64."""
    import contextlib
    import io

    archive = work_dir / "archive"
    publish_fused("recnext_m1", read_weights(str(checkpoint)), str(archive))
    rec = {"phase": "finetune", "args": FINETUNE_ARGS}
    for source, path in (("checkpoint", checkpoint),
                         ("fused_archive", archive / "recnext_m1_fused.pt")):
        out_dir = work_dir / f"run_{source}"
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = train_main.main(FINETUNE_ARGS + ["--finetune", str(path),
                                                   "--output-dir", str(out_dir)])
        torch.cuda.synchronize()
        launches = counts()  # ... and ends here
        text = buf.getvalue()
        losses = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                  if ": loss " in line]
        stats = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
        k1 = (launches["rec_conv2d"] - 23 * FINETUNE_EVALS) / FINETUNE_STEPS
        k1b = launches["rec_conv2d_backward"] / FINETUNE_STEPS
        run = {"seconds": time.perf_counter() - t0, "losses": losses, "epoch_lines": stats,
               "launches": launches, "k1_launches_per_micro_step": k1,
               "k1_backward_calls_per_micro_step": k1b,
               "heads_dropped": text.count("Removing key"),
               "updates": res["state"].optimizer.count, "micro_steps": res["state"].step}
        rec[source] = run
        others = {k: v for k, v in launches.items()
                  if k not in ("rec_conv2d", "rec_conv2d_backward")}
        if (len(losses) != FINETUNE_STEPS or not all(np.isfinite(losses)) or len(stats) != 1
                or k1 != 69 or k1b != 23 or any(others.values()) or run["heads_dropped"] != 4
                or run["updates"] != FINETUNE_STEPS // 2):
            raise AssertionError(f"finetune from the {source}: {run}")
    csv_path = work_dir / "results.csv"
    result = validate_main.main(["--model", "recnext_m1", "--checkpoint",
                                 str(work_dir / "run_checkpoint" / "ckpt" / "epoch_0000.pt"),
                                 "--fused", "--ema", "--data-set", "FAKE", "--fake-classes",
                                 "100", "--input-size", "384", "--batch-size", "32",
                                 "--max-batches", "2", "--dtype", "bfloat16",
                                 "--results-file", str(csv_path)])
    row = csv_path.read_text().splitlines()
    if len(row) != 2 or result["count"] != 64 or not np.isfinite(result["top1"]):
        raise AssertionError(f"validate: {result}, {row}")
    rec["validate"] = {"result": result, "csv": row}
    kw = dict(image_size=384, grad_accum=2, remat=True, mesa=1.0)
    step = bench.train_bench_step("recnext_m1", 64, **kw)
    ips, batch, spread = bench.train_throughput("recnext_m1", 64, repeats=TIMED_REPEATS,
                                                timed_s=TIMED_S, step=step)
    kernels = trace(step[0], iters=2, warmup=1)
    busy = sum(k["ms"] for k in kernels)
    step_ms = batch / ips * 1e3
    launches = {kn: sum(k["launches"] for k in kernels if kn in k["name"])
                for kn in TRACE_KERNELS["recnext_m1"]}
    if launches != {"recconv_kernel": 69, "recconv_bwd_kernel": 23,
                    "recconv_bwd_sum_kernel": 23} or busy > step_ms:
        raise AssertionError(f"finetune step trace: {launches}, busy {busy} of {step_ms} ms")
    rec["step_384"] = {"batch": batch, "options": "grad_accum 2, remat, MESA 1.0",
                       "images_per_s_median": ips, "spread": spread,
                       "micro_step_ms": step_ms, "device_busy_ms_per_micro_step": busy,
                       "device_idle_share": 1 - busy / step_ms,
                       "kernel_launches_per_micro_step": launches,
                       "top_kernels": kernels[:8]}
    emit(rec)


INPUT_IMAGES, INPUT_COPIES, INPUT_VAL, INPUT_CLASSES, INPUT_PNGS = 256, 2, 256, 10, 3
INPUT_BATCH = 128
INPUT_STEPS = INPUT_IMAGES * INPUT_COPIES // INPUT_BATCH  # RA keeps n // 256 * 256: all
INPUT_EVAL_FORWARDS = 2 * (INPUT_VAL // INPUT_BATCH)  # the model and its EMA, 2 batches


def write_input_folders(root: Path):
    """The phase's data: ``INPUT_IMAGES`` 500x375 JPEGs in ``INPUT_CLASSES`` classes
    (``bench.make_folder``), listed ``INPUT_COPIES`` times under hard links in
    ``root``/jpeg/train (so an epoch is ``INPUT_STEPS`` steps of a batch, each copy a
    sample of its own draws), the first ``INPUT_VAL`` in jpeg/val; and a copy of 64 of
    them in which ``INPUT_PNGS`` are PNGs (pngs/train). Returns the folder of the
    distinct JPEGs, the FOLDER root and the PNG folder."""
    from PIL import Image

    unique = root / "unique"
    bench.make_folder(unique, INPUT_IMAGES, classes=INPUT_CLASSES)
    files = sorted(unique.rglob("*.jpg"))
    for copy in range(INPUT_COPIES):
        for f in files:
            d = root / "jpeg" / "train" / f.parent.name
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{copy}_{f.name}").hardlink_to(f)
    for f in files:
        if int(f.stem) < INPUT_VAL:
            d = root / "jpeg" / "val" / f.parent.name
            d.mkdir(parents=True, exist_ok=True)
            (d / f.name).hardlink_to(f)
    for f in files[:64]:
        d = root / "pngs" / "train" / f.parent.name
        d.mkdir(parents=True, exist_ok=True)
        if int(f.stem) % 20 == 0 and len(list(root.glob("pngs/train/*/*.png"))) < INPUT_PNGS:
            Image.open(f).save(d / f"{f.stem}.png", "PNG")
        else:
            (d / f.name).hardlink_to(f)
    return unique, root / "jpeg", root / "pngs" / "train"


def phase_input_pipeline(work_dir: Path, step_ips: float, step_busy_ms: float):
    """The data pipeline on the card's host, then m1 trained from a folder of JPEGs.

    1. the host: its CPU count and affinity, /dev/shm's size (worker batches pass
       through it), and the native decoder's build against Pillow's libjpeg (which
       must succeed);
    2. ``bench.loader_bench`` over the distinct JPEGs at 224^2, batch 32: PIL and
       native, the full and the simple train transform, at workers 0 and W = min(16,
       CPUs);
    3. the first 3 batches of 128 (the full transform, the RA sampler) at workers 0 and
       W carry the same bits, on each route that builds; native_fallback_batches is 0
       on the JPEGs and above 0 on the folder with PNGs;
    4. the trainer (``train.main.main``) on m1, FOLDER, the full reference transform,
       the RA sampler, batch 128, one epoch of ``INPUT_STEPS`` steps: with --workers W,
       with --native-loader (the decoder's C++ threads in the trainer's own
       process), then with --native-loader and --workers W; each run with every count set to 0
       just before it and read just after: 23 K1 launches and 23 K1' calls a train
       step, 23 K1 launches a fused eval forward, nothing else. Its img/s (the
       epoch's, and steady: after the first batch) beside the step alone's
       (``step_ips``, from the train_throughput phase of this run), and the device's
       idle share in the loop from the step's busy time in that phase's trace
       (``step_busy_ms``, device time a step, which does not depend on the host);
    5. validate.py on the val split with the trained checkpoint: the PIL route, and
       --native-loader against its top-1 (within 4 of 256 images: the routes' pixels
       differ by PIL's uint8 rounding)."""
    import contextlib
    import io

    from recnext_tpu_torch.data import native as native_io
    from recnext_tpu_torch.data.datasets import ImageFolder
    from recnext_tpu_torch.data.loader import train_loader
    from recnext_tpu_torch.data.transforms import TrainTransform

    cpus = bench.host_cpus()
    workers = min(16, cpus["cpu_count"])
    shm = shutil.disk_usage("/dev/shm")
    t0 = time.perf_counter()
    native_io.load()  # raises NativeBuildError where it cannot build: the phase fails
    rec = {"phase": "input_pipeline", **cpus, "workers": workers,
           "dev_shm_bytes": shm.total, "native_build_s": time.perf_counter() - t0,
           "native_library": native_io.library_path().name,
           "native_libjpeg": str(native_io.pillow_libjpeg())}
    t0 = time.perf_counter()
    unique, root, pngs = write_input_folders(work_dir / "input")
    rec["write_folders_s"] = time.perf_counter() - t0

    rec["loader"] = bench.loader_bench(ImageFolder(unique), size=224, batch=32,
                                       workers=(0, workers), pin_memory=True)
    for r in rec["loader"]:
        if r["value"] is None:
            raise AssertionError(f"input_pipeline: {r}")

    def first_batches(ds, native, w, n=3, batch=INPUT_BATCH):
        loader = train_loader(ds, TrainTransform(224), batch_size=batch, epoch=0,
                              native=native, workers=w, pin_memory=True)
        out = []
        for batch_ in loader:
            out.append(batch_)
            if len(out) == n:
                break
        return out, loader

    train_ds = ImageFolder(root / "train")
    rec["same_bits"] = {}
    for native in (False, True):
        (a, la), (b, lb) = (first_batches(train_ds, native, 0),
                            first_batches(train_ds, native, workers))
        same = all(torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])
                   for x, y in zip(a, b)) and len(a) == len(b) == 3
        route = "native" if native else "pil"
        rec["same_bits"][route] = {"workers": [0, workers], "batches": 3, "same": same,
                                   "routes": [la.route, lb.route],
                                   "fallback_batches": [la.native_fallback_batches,
                                                        lb.native_fallback_batches]}
        if not same or la.route != route or la.native_fallback_batches:
            raise AssertionError(f"input_pipeline bits: {rec['same_bits'][route]}")
    _, lp = first_batches(ImageFolder(pngs), True, workers, n=6, batch=32)
    rec["png_fallback_batches"] = lp.native_fallback_batches
    if lp.native_fallback_batches == 0:
        raise AssertionError("input_pipeline: no batch of the PNG folder fell back")

    args = ["--model", "recnext_m1", "--data-set", "FOLDER", "--data-path", str(root),
            "--input-size", "224", "--batch-size", str(INPUT_BATCH), "--epochs", "1",
            "--log-every", "10", "--seed", "0"]
    runs, ckpt = {}, None
    for name, extra in (("workers", ["--workers", str(workers)]),
                        ("native", ["--native-loader"]),
                        ("native_workers", ["--native-loader", "--workers", str(workers)])):
        out_dir = work_dir / f"input_{name}"
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_main.main(args + extra + ["--output-dir", str(out_dir)])
        torch.cuda.synchronize()
        launches = counts()  # ... and ends here
        text = buf.getvalue()
        (stats,) = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
        losses = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                  if ": loss " in line]
        per_step = {"rec_conv2d": (launches["rec_conv2d"] - 23 * INPUT_EVAL_FORWARDS)
                    / INPUT_STEPS, "rec_conv2d_backward": launches["rec_conv2d_backward"]
                    / INPUT_STEPS}
        others = {k: v for k, v in launches.items() if k not in per_step}
        steady_s = stats["train_s"] - stats["loader_first_batch_s"]
        steady_ips = (INPUT_STEPS - 1) * INPUT_BATCH / steady_s
        run = {"seconds": time.perf_counter() - t0, "losses": losses, "epoch_line": stats,
               "launches": launches, "launches_per_train_step": per_step,
               "images_per_s_epoch": stats["train_images_per_sec"],
               "images_per_s_after_first_batch": steady_ips,
               "step_alone_images_per_s": step_ips,
               "loader_wait_share_after_first_batch":
                   (stats["loader_wait_s"] - stats["loader_first_batch_s"]) / steady_s,
               "device_idle_share_after_first_batch":
                   1 - step_busy_ms * (INPUT_STEPS - 1) / 1e3 / steady_s,
               "device_idle_share_step_alone": 1 - step_busy_ms * step_ips / INPUT_BATCH / 1e3}
        runs[name] = run
        want_route = "native" if "--native-loader" in extra else "pil"
        if (per_step != {"rec_conv2d": 23, "rec_conv2d_backward": 23} or any(others.values())
                or len(losses) != INPUT_STEPS // 10 or not all(np.isfinite(losses))
                or not np.isfinite(stats["train_loss"])
                or stats["loader_route"] != want_route
                or stats["eval_loader_route"] != want_route
                or stats["native_fallback_batches"] != 0):
            raise AssertionError(f"input_pipeline train {name}: {run}")
        ckpt = ckpt or out_dir / "ckpt" / "epoch_0000.pt"
    rec["train"] = runs

    vargs = ["--model", "recnext_m1", "--checkpoint", str(ckpt), "--ema", "--fused",
             "--data-set", "FOLDER", "--data-path", str(root), "--input-size", "224",
             "--batch-size", str(INPUT_BATCH), "--dtype", "bfloat16"]
    with contextlib.redirect_stdout(io.StringIO()):
        pil = validate_main.main(vargs)
        nat = validate_main.main(vargs + ["--native-loader"])
    rec["validate"] = {"pil": pil, "native": nat}
    if (pil["count"] != INPUT_VAL or pil["loader_route"] != "pil" or nat["count"] != INPUT_VAL
            or nat["loader_route"] != "native"
            or abs(nat["top1"] - pil["top1"]) > 100 * 4 / INPUT_VAL):
        raise AssertionError(f"input_pipeline validate: {rec['validate']}")
    emit(rec)


def _mlla_expected(variant, per_forward=1, per_step=0):
    """Every count 0 but ``variant``'s kernels: its forward kernel ``per_forward`` x 21
    launches, its backward ``per_step`` x 21 calls."""
    out = dict.fromkeys(COUNTERS, 0)
    if MLLA_KERNELS[variant]:
        fwd, bwd = MLLA_KERNELS[variant]
        out[fwd], out[bwd] = MLLA_MIXERS * per_forward, MLLA_MIXERS * per_step
    return out


def _heads_rows(t, heads):
    """(B, nh*R, H, W) -> (B*nh, N, R), contiguous."""
    b, c, h, w = t.shape
    return t.reshape(b * heads, c // heads, h * w).transpose(1, 2).contiguous()


def phase_mlla_kernels():
    """K1 and K1′ (nearest) at mlla_mini_recconv's four shapes and K2 and K2′ at
    mlla_mini_recattn_simple's seven, each against its plain version on the inputs it
    is timed on (forward: batch 256, f32 and bf16; backward: batch 128), at phase 2's,
    7's, 11's and 15's bounds (K1 and K2 also at batch 8); each shape's launch
    configuration; device times (CUDA events around calls queued behind other work:
    the profiler has seen no device time in a long process) beside the bound and the
    plain version, and their sums over a forward (K1, K2) or a train step (K1′, K2′).
    Every kernel must beat its plain version."""
    gen = torch.Generator().manual_seed(21)
    totals = {k: [] for k in ("rec_conv2d", "rec_conv2d_backward", "linear_attention",
                              "linear_attention_backward")}
    errs = dict.fromkeys(totals, 0.0)

    def add(kernel, uses, times, nbytes, flops):
        totals[kernel].append((uses, times, nbytes, flops))
        if not times["kernel_ms"] <= times["plain_ms"]:
            raise AssertionError(f"mlla_kernels: {kernel} slower than its plain version: {times}")

    for level, (c, side, uses) in MLLA_K1.items():
        cfg = recconv_cuda.launch_config(side, side, level, 5, 2)
        bcfg = recconv_bwd_cuda.launch_config(side, side, level, 5)._asdict()
        del bcfg["geometry"]
        rec = {"phase": "mlla_kernels", "kernel": "rec_conv2d", "mode": "nearest",
               "channels": c, "side": side, "level": level, "launches_per_forward": uses,
               "launch": {"team": cfg.team, "planes_per_block": cfg.planes_per_block,
                          "shared_bytes": cfg.smem_bytes},
               "backward_launch": dict(bcfg, resident_blocks_per_sm=(
                   recconv_bwd_cuda.resident_blocks(side, side, level, 5, torch.bfloat16)))}
        x, ws = _recconv_inputs(gen, 8, c, side, side, level, torch.float32)
        rec["batch_8"] = _check_recconv(x, ws, level, "nearest")
        x, ws = _recconv_inputs(gen, MLLA_BATCH, c, side, side, level, torch.float32)
        rec["batch_256"] = _check_recconv(x, ws, level, "nearest")  # then timed in bf16
        errs["rec_conv2d"] = max(errs["rec_conv2d"], rec["batch_256"]["bf16_max_abs_err"])
        xt, wst = x.bfloat16(), [t.bfloat16() for t in ws]
        times = {"kernel_ms": queued_ms(lambda: rec_conv2d_fused(
                     xt, wst[0], wst[1:], level=level, mode="nearest")),
                 "plain_ms": queued_ms(lambda: rec_conv2d(
                     xt, wst[0], wst[1:], level=level, mode="nearest"), iters=5)}
        nbytes, flops = recconv_work(MLLA_BATCH, c, side, side, level, 5, 2)
        add("rec_conv2d", uses, times, nbytes, flops)
        rec["batch_256_bf16"] = dict(times, bound_ms=bound(nbytes, flops)[0],
                                     bound_by=bound(nbytes, flops)[1], library_ms=None)
        # K1′ at the train step's batch, f32 and bf16, timed in bf16
        xb = torch.randn(MLLA_TRAIN_BATCH, c, side, side, generator=gen)
        gb = torch.randn(MLLA_TRAIN_BATCH, c, side, side, generator=gen)
        wb = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(level + 2)]
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = xb.to("cuda", dtype), gb.to("cuda", dtype)
            wd = [t.to("cuda", dtype) for t in wb]
            errs_b, worst = _check_backward(xd, wd, gd, level, "nearest")
            rec[f"backward_{str(dtype)[6:]}_err_over_max_ref"] = errs_b
            if dtype == torch.bfloat16:
                errs["rec_conv2d_backward"] = max(errs["rec_conv2d_backward"], worst)
        bt = {"kernel_ms": queued_ms(lambda: rec_conv2d_backward(
                  xd, wd[0], wd[1:], gd, level=level, mode="nearest"), iters=10),
              "plain_ms": queued_ms(lambda: rec_conv2d_backward_plain(
                  xd, wd[0], wd[1:], gd, level=level, mode="nearest"), iters=3)}
        nbytes, flops = recconv_bwd_work(MLLA_TRAIN_BATCH, c, side, side, level, 5, 2)
        add("rec_conv2d_backward", uses, bt, nbytes, flops)
        rec["backward_batch_128_bf16"] = dict(bt, bound_ms=bound(nbytes, flops)[0],
                                              bound_by=bound(nbytes, flops)[1], library_ms=None)
        emit(rec)

    for (heads, side, d), uses in MLLA_K2.items():
        n = side * side
        lcfg = {k: v for k, v in attention_cuda.launch_config(n, d, d, 2, "n")._asdict().items()
                if k != "geometry"}
        bcfg = attention_bwd_cuda.launch_config(n, d, d, 2, "n")
        rec = {"phase": "mlla_kernels", "kernel": "linear_attention", "heads": heads, "n": n,
               "d": d, "dv": d, "launches_per_forward": uses, "launch": lcfg,
               "backward_launch": {
                   **{k: v for k, v in bcfg._asdict().items() if k != "geometry"},
                   **attention_bwd_cuda.kernel_attributes(torch.bfloat16, bcfg.route),
                   "resident_blocks": attention_bwd_cuda.resident_blocks(bcfg, torch.bfloat16)}}

        def inputs(b):  # elu(x)+1-like q and k in one tensor, v
            qk = torch.randn(b, 2 * heads * d, side, side, generator=gen).abs() + 0.1
            return qk.cuda(), torch.randn(b, heads * d, side, side, generator=gen).cuda()

        for b in (8, MLLA_BATCH):
            qk, v = inputs(b)
            for dtype in (torch.float32, torch.bfloat16):
                qkx, vx = qk.to(dtype), v.to(dtype)
                want = linear_attention_nchw_plain(qkx.float(), vx.float(), heads)
                got = linear_attention_nchw(qkx, vx, heads).float()
                torch.cuda.synchronize()
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                ok = (bool(((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all())
                      if dtype == torch.float32 else err <= 1e-2 * scale)
                rec[f"batch_{b}_{str(dtype)[6:]}_max_abs_err"] = err
                rec[f"batch_{b}_{str(dtype)[6:]}_max_abs_ref"] = scale
                if not ok:
                    raise AssertionError(f"mlla_kernels: K2 {dtype} mismatch at {(heads, side, d)} "
                                         f"batch {b}: {err} (max|ref| {scale})")
        errs["linear_attention"] = max(errs["linear_attention"],
                                       rec[f"batch_{MLLA_BATCH}_bfloat16_max_abs_err"])
        qkt, vt = qk.bfloat16(), v.bfloat16()  # the batch-256 inputs just checked
        kernel = lambda: linear_attention_nchw(qkt, vt, heads)  # noqa: E731
        plain = lambda: linear_attention_nchw_plain(qkt, vt, heads)  # noqa: E731
        times = {"kernel_ms": queued_ms(kernel), "plain_ms": queued_ms(plain, iters=10)}
        nbytes, flops = attention_work(MLLA_BATCH, heads, n, d, d, 2)
        add("linear_attention", uses, times, nbytes, flops)
        rec["batch_256_bf16"] = dict(times, bound_ms=bound(nbytes, flops)[0],
                                     bound_by=bound(nbytes, flops)[1], library_ms=None)
        # K2′ at the train step's batch, f32 and bf16 (the same bits on three runs)
        qk, v = inputs(MLLA_TRAIN_BATCH)
        g = torch.randn(v.shape, generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            qkx, vx, gx = qk.to(dtype), v.to(dtype), g.to(dtype)
            want = linear_attention_backward_plain(*(_heads_rows(t.float(), heads) for t in (
                qkx[:, : heads * d], qkx[:, heads * d:], vx, gx)))
            runs = [linear_attention_nchw_backward(qkx, vx, gx, heads) for _ in range(3)]
            torch.cuda.synchronize()
            dqk, dv = runs[0]
            got = tuple(_heads_rows(t, heads)
                        for t in (dqk[:, : heads * d], dqk[:, heads * d:], dv))
            e, r = _check_attention_grads(got, want, dtype, ((heads, side, d), str(dtype)))
            if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0])):
                raise AssertionError(f"mlla_kernels: K2′ not the same bits on 3 runs at "
                                     f"{(heads, side, d)} {dtype}")
            rec[f"backward_{str(dtype)[6:]}_max_abs_err"] = e
            rec[f"backward_{str(dtype)[6:]}_err_over_max_ref"] = r
        errs["linear_attention_backward"] = max(errs["linear_attention_backward"],
                                                *rec["backward_bfloat16_max_abs_err"].values())
        rows = [_heads_rows(t, heads) for t in (qkx[:, : heads * d], qkx[:, heads * d:], vx, gx)]
        bt = {"kernel_ms": queued_ms(lambda: linear_attention_nchw_backward(qkx, vx, gx, heads)),
              "plain_ms": queued_ms(lambda: linear_attention_backward_plain(*rows), iters=5)}
        nbytes, flops = attention_bwd_work(MLLA_TRAIN_BATCH, heads, n, d, d, 2)
        add("linear_attention_backward", uses, bt, nbytes, flops)
        rec["backward_batch_128_bf16"] = dict(bt, bound_ms=bound(nbytes, flops)[0],
                                              bound_by=bound(nbytes, flops)[1], library_ms=None)
        emit(rec)

    out = {}
    for kernel, rows in totals.items():
        t = {key: sum(u * times[key] for u, times, _, _ in rows)
             for key in ("kernel_ms", "plain_ms")}
        t["bytes"] = sum(u * nb for u, _, nb, _ in rows)
        t["flops"] = sum(u * fl for u, _, _, fl in rows)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
        t["library_ms"] = None
        out[kernel] = t
        emit({"phase": "mlla_kernels_total", "kernel": kernel, "launches": MLLA_MIXERS,
              "per": "forward, batch 256" if "backward" not in kernel else "train step, batch 128",
              **t})
    return out, errs


def phase_mlla_model(variant, batch=8):
    """mlla_mini_<variant> at full width and depth, 256^2, batch ``batch``, seeded
    weights: the eval-mode (unfused) logits through the kernels against the plain path
    in f32 (1e-4 max|ref|) and bf16 (1e-1 max|ref| of the f32 plain path's, and of the
    bf16 plain path's), with 21 launches of the variant's kernel a forward (none for
    recattn); then, in train mode, f32, every parameter's gradient through the
    kernels (the forward kernel and its backward) against the plain path at 1e-3
    max|ref|, the same drop-path masks on both paths. Counts are set to 0 just before
    each kernel path and read just after."""
    import copy

    name = f"mlla_mini_{variant}"
    gen = torch.Generator().manual_seed(22)
    model = create_mlla(name, device="cuda", generator=gen)
    x = torch.randn(batch, 3, MLLA_SIDE, MLLA_SIDE, generator=gen).cuda()
    out = {"phase": "mlla_model", "model": name, "input": [batch, 3, MLLA_SIDE, MLLA_SIDE]}
    want = _mlla_expected(variant)
    with torch.inference_mode():
        restore = plain_path(model)
        ref = model(x).float()
        restore()
        for label, dtype, tol in (("f32", torch.float32, 1e-4), ("bf16", torch.bfloat16, 1e-1)):
            m = copy.deepcopy(model).to(dtype)
            xin = x.to(dtype)
            for fn in COUNTERS.values():  # the path starts here
                fn.launches = 0
            got = m(xin).float()
            torch.cuda.synchronize()
            launches = counts()  # ... and ends here
            if launches != want:
                raise AssertionError(f"{name} {label}: launches {launches}, expected {want}")
            restore = plain_path(m)
            plain = m(xin).float()
            restore()
            if got.shape != (batch, 1000) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {label}: bad logits {tuple(got.shape)}")
            scale = ref.abs().max().item()
            e_ref, e_plain = (got - ref).abs().max().item(), (got - plain).abs().max().item()
            out[label] = {"launches_per_forward": launches, "max_abs_err_vs_f32_plain": e_ref,
                          "max_abs_err_vs_plain_path": e_plain, "max_abs_logit": scale,
                          "top1_agree_vs_f32_plain":
                              (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                          "tol": tol * scale}
            if not (e_ref <= tol * scale and e_plain <= tol * scale):
                raise AssertionError(f"{name} {label} logits disagree: {out[label]}")
    y = torch.randint(0, 1000, (batch,), generator=gen).cuda()
    model.train()
    grads = {}
    for path in ("kernel_path", "plain_path"):
        m = copy.deepcopy(model)
        restore = plain_path(m) if path == "plain_path" else None
        torch.manual_seed(5)  # the same drop-path masks on both paths
        for fn in COUNTERS.values():  # the path starts here
            fn.launches = 0
        loss = train_loss(m, x, y, dtype=torch.float32)
        loss.backward()
        torch.cuda.synchronize()
        launches = counts()  # ... and ends here
        if restore:
            restore()
        expect = (_mlla_expected(variant, 1, 1) if path == "kernel_path"
                  else dict.fromkeys(COUNTERS, 0))
        if launches != expect:
            raise AssertionError(f"{name} {path}: launches {launches}, expected {expect}")
        grads[path] = {n: p.grad for n, p in m.named_parameters()}
        out[f"train_{path}"] = {"loss": loss.item(), "launches": launches}
    worst, zero = (0.0, ""), 0
    for pname, ref_g in grads["plain_path"].items():
        got_g, scale = grads["kernel_path"][pname], ref_g.abs().max().item()
        if scale < 1e-6:
            zero += 1
            if not got_g.abs().max().item() < 1e-5:
                raise AssertionError(f"{name} {pname}: gradient where the plain path's is 0")
            continue
        ratio = (got_g - ref_g).abs().max().item() / scale
        worst = max(worst, (ratio, pname))
        if not ratio <= 1e-3:
            raise AssertionError(f"{name} {pname}: kernel-path gradient off by {ratio} max|ref|")
    out["train_grad"] = {"parameters": len(grads["plain_path"]), "zero_gradient_tensors": zero,
                         "worst_err_over_max_ref": worst[0], "worst_parameter": worst[1],
                         "tol": 1e-3}
    emit(out)
    return out["bf16"]["launches_per_forward"], out["train_kernel_path"]["launches"]


LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "transpose", "copy_kernel", "CatArrayBatchedCopy")


def phase_mlla_throughput(variant, kernel_sum_ms):
    """mlla_mini_<variant> in eval mode, bf16, unfused (bench.py's MLLA model), at 256^2,
    batch 256 and batch 1: ms a forward by CUDA events, img/s, and from a profiler
    trace the device's busy time and idle share, the kernel's time in it, the layout
    copies' (transposes between NCHW and channels-last, copies), and the top kernels."""
    name = f"mlla_mini_{variant}"
    model = bench.inference_model(name, torch.bfloat16, torch.device("cuda"))
    gen = torch.Generator().manual_seed(24)
    x256 = torch.randn(MLLA_BATCH, 3, MLLA_SIDE, MLLA_SIDE, generator=gen).to(
        "cuda", torch.bfloat16)
    x1 = x256[:1].contiguous()
    out = {"phase": "mlla_throughput", "model": name, "dtype": "bfloat16", "fused": False}
    kname = MLLA_TRACE[variant][0]
    with torch.inference_mode():
        ms256 = cuda_ms(lambda: model(x256), iters=10, warmup=3)
        ms1 = cuda_ms(lambda: model(x1), iters=20, warmup=5)
        out.update(batch_256_ms=ms256, images_per_s=MLLA_BATCH * 1e3 / ms256,
                   batch_1_latency_ms=ms1)
        for batch, x, ms in ((MLLA_BATCH, x256, ms256), (1, x1, ms1)):
            kernels = trace(lambda: model(x), iters=3 if batch > 1 else 5)
            busy = sum(k["ms"] for k in kernels)
            ours = [k for k in kernels if kname in k["name"]]
            layout = [k for k in kernels if any(s in k["name"] for s in LAYOUT_KERNELS)]
            out[f"batch_{batch}_trace"] = {
                "device_busy_ms": busy, "device_idle_share": 1 - busy / ms,
                "kernel_ms": sum(k["ms"] for k in ours),
                "kernel_launches": sum(k["launches"] for k in ours),
                "kernel_share_of_busy": sum(k["ms"] for k in ours) / busy,
                "layout_copies_ms": sum(k["ms"] for k in layout),
                "layout_copy_launches": sum(k["launches"] for k in layout),
                "top_kernels": kernels[:12]}
            if sum(k["launches"] for k in ours) != MLLA_MIXERS:
                raise AssertionError(f"{name}: the trace lists {ours} for the kernel, not "
                                     f"{MLLA_MIXERS} launches a forward")
    out["kernel_sum_ms"] = kernel_sum_ms
    out["kernel_share"] = kernel_sum_ms / ms256
    emit(out)
    return out


def phase_mlla_train_throughput(variant):
    """bench.train_throughput("mlla_mini_<variant>", 128, mesa=1.0): the MLLA recipe's
    step (mixup, bf16 compute, global-norm clip 5.0, AdamW, EMA, MESA's EMA forward)
    at 256^2, 2 repeats of 1.5 s; then a profiler trace of 2 steps: 42 launches a step of
    the forward kernel (the model's and the EMA model's forward) and 21 of the
    backward's, the device's busy time and idle share, the top kernels."""
    name = f"mlla_mini_{variant}"
    step = bench.train_bench_step(name, MLLA_TRAIN_BATCH, mesa=1.0)
    ips, batch, spread = bench.train_throughput(name, MLLA_TRAIN_BATCH, repeats=TIMED_REPEATS,
                                                timed_s=TIMED_S, step=step)
    step_ms = batch / ips * 1e3
    kernels = trace(step[0], iters=2, warmup=1)
    busy = sum(k["ms"] for k in kernels)
    ours = {kn: sum(k["ms"] for k in kernels if kn in k["name"]) for kn in MLLA_TRACE[variant]}
    launches = {kn: sum(k["launches"] for k in kernels if kn in k["name"])
                for kn in MLLA_TRACE[variant]}
    want = {kn: 2 * MLLA_MIXERS if i == 0 else MLLA_MIXERS
            for i, kn in enumerate(MLLA_TRACE[variant])}
    if launches != want or busy > step_ms:
        raise AssertionError(f"mlla_train_throughput {name}: launches a step {launches} "
                             f"(expected {want}), busy {busy} ms of {step_ms}")
    rec = {"phase": "mlla_train_throughput", "model": name, "batch": batch,
           "recipe": "mixup, norm clip 5.0, AdamW wd 0.05, EMA, MESA 1.0 from step 0",
           "images_per_s_median": ips, "spread": spread, "step_ms": step_ms,
           "device_busy_ms_per_step": busy, "device_idle_share": 1 - busy / step_ms,
           "kernel_ms_per_step": ours, "kernel_launches_per_step": launches,
           "top_kernels": kernels[:10]}
    emit(rec)
    return rec


def phase_mlla_train():
    """The trainer with the MLLA recipe's preset, ``--config configs/mlla_mini_300e.yaml
    --model mlla_mini_recconv --data-set FAKE`` (batch 64, 3 steps an epoch), PyYAML
    made unimportable for the run: 2 epochs, then a rerun to 3 that resumes. Counts set
    to 0 just before each run and read just after: 21 K1′ calls a train step, and 21
    K1 launches for each train step, MESA forward (the EMA model's) and unfused eval
    forward; nothing else."""
    import contextlib
    import io

    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    rec = {"phase": "mlla_train", "args": MLLA_TRAIN_ARGS}
    saved_yaml = sys.modules.get("yaml")
    with tempfile.TemporaryDirectory(dir=build) as run_dir:
        runs = []
        for epochs in (2, 3):
            for fn in COUNTERS.values():  # the path starts here
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            sys.modules["yaml"] = None  # an `import yaml` on the path raises
            try:
                with contextlib.redirect_stdout(buf):
                    train_main.main(MLLA_TRAIN_ARGS + ["--epochs", str(epochs),
                                                       "--output-dir", run_dir])
            finally:
                if saved_yaml is None:
                    del sys.modules["yaml"]
                else:
                    sys.modules["yaml"] = saved_yaml
            torch.cuda.synchronize()
            launches = counts()  # ... and ends here
            text = buf.getvalue()
            ran = epochs - (2 if epochs == 3 else 0)
            steps = TRAIN_STEPS_PER_EPOCH * ran
            forwards = steps + MLLA_MESA_FORWARDS[epochs] + EVAL_FORWARDS_PER_EPOCH * ran
            losses = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                      if ": loss " in line]
            stats = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
            want = dict.fromkeys(COUNTERS, 0) | {"rec_conv2d": MLLA_MIXERS * forwards,
                                                 "rec_conv2d_backward": MLLA_MIXERS * steps}
            run = {"epochs": epochs, "seconds": time.perf_counter() - t0, "losses": losses,
                   "epoch_lines": stats, "launches": launches, "expected": want,
                   "resumed": "auto-resumed at epoch 2" in text,
                   "checkpoints": sorted(p.name for p in (Path(run_dir) / "ckpt").iterdir())}
            runs.append(run)
            if (len(losses) != steps or not all(np.isfinite(losses)) or len(stats) != ran
                    or launches != want or run["resumed"] != (epochs == 3)):
                raise AssertionError(f"mlla train run to {epochs} epochs: {run}")
            args = json.loads((Path(run_dir) / "args.json").read_text())
            preset = ("clip_mode", "clip_grad", "mesa", "weight_decay", "warmup_epochs")
            if tuple(args[k] for k in preset) != ("norm", 5.0, 1.0, 0.05, 20):
                raise AssertionError(f"the preset was not read: {args}")
        rec["runs"] = runs
    emit(rec)
    return runs[0]["launches"]


# ---------------------------------------------------------------- the downstream tasks
# recnext_m3 Semantic FPN (crop 512) and RetinaNet (800^2, the detection preset's short
# side), batch 16, fp32, as the task CLIs run their presets; recnext_a3 Semantic FPN at
# 512^2 for K2 and K2'
SEG_PRESET, DET_PRESET = "seg_recnext_m3_fpn_ade20k_40k", "det_recnext_m3_fpn_1x_coco"
SEG_SIDE, DET_SIDE, TASK_BATCH, DET_BATCH = 512, 800, 16, 16
M3_STAGES = ((3, 64), (3, 128), (13, 256), (2, 512))  # (depth, channels)
# a3 at 512^2: stage -> (heads, side of the attention map, variant); D = 32 throughout
A3_ATTENTION = {0: (2, 64, 1), 1: (4, 32, 1), 2: (8, 16, 1), 3: (16, 8, 2)}
A3_DEPTHS, A3_HEAD_DIM = (3, 3, 13, 2), 32
# (part, N) of a3's attention shapes where the kernel is known to lose to its plain
# version in f32 at batch 16: K2 and K2′'s tiled route give a head one block, and BH 32
# (N 4096) or 64 (N 1024) blocks leave most of the 132 SMs idle; ROADMAP Queue 2 holds
# the plan (N split across blocks). Any other shape that loses fails the phase.
A3_SLOWER_THAN_PLAIN = {("forward", 4096), ("forward", 1024), ("backward", 4096)}
TASK_TRACE = ("recconv_kernel", "recconv_level_kernel", "recconv_bwd_kernel",
              "recconv_bwd_sum_kernel", "recconv_level_dgrad_kernel",
              "recconv_level_wgrad_kernel", "recconv_level_wgrad_sum_kernel",
              "recconv_up_adjoint_kernel")


def m3_task_launches(side):
    """The launches of one recnext_m3 forward and of one train step (forward and
    backward) on a side^2 input, from the planners: per mixer (stage i at plane
    ceil(side / 2^(i+2)), level 4 - i) one K1 launch and two level-kernel launches a
    peeled level (``levels_to_peel`` at fp32), and in the backward one K1′ call, or
    where its plane peels (``levels_to_peel_backward``) ``peeled_backward_launches``."""
    fwd, step = dict.fromkeys(COUNTERS, 0), dict.fromkeys(COUNTERS, 0)
    plane = ((side + 1) // 2 + 1) // 2
    for i, (depth, _) in enumerate(M3_STAGES):
        level = 4 - i
        f = {"rec_conv2d": 1,
             "rec_conv2d_level": 2 * recconv_cuda.levels_to_peel(plane, plane, level, 5, 4)}
        b = (peeled_backward_launches(plane, plane, level, 5)
             if recconv_bwd_cuda.levels_to_peel_backward(plane, plane, level, 5)
             else {"rec_conv2d_backward": 1})
        for k, v in f.items():
            fwd[k] += depth * v
            step[k] += depth * v
        for k, v in b.items():
            step[k] += depth * v
        plane = (plane + 1) // 2
    return fwd, step


def a3_task_launches():
    """recnext_a3's train step: one K2 launch and one K2′ call a mixer."""
    return dict.fromkeys(COUNTERS, 0) | {"linear_attention": sum(A3_DEPTHS),
                                         "linear_attention_backward": sum(A3_DEPTHS)}


def classifier_checkpoint(name, path: Path) -> Path:
    """A classification checkpoint of ``name`` for the task recipes' ``--init-ckpt`` (the
    recipes start from a pretrained backbone): seeded weights, BN affine drawn and
    running statistics from one random batch (``calibrated``), saved as a bare state
    dict. With the init's identity statistics a frozen-BN backbone's activations grow
    without bound through its blocks (recnext_m3's C5 reaches ~1e24 at 512^2), and the
    head's BatchNorm sees an infinite variance."""
    torch.save(calibrated(name).state_dict(), path)
    return path


def _times(n, per):
    return {k: n * v for k, v in per.items()}


def _added(*dicts):
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def _run_cli(main, argv, expected, what):
    """``main(argv)`` with every count set to 0 just before and read just after (the
    main path); its stdout's JSON lines. Raises unless the counts are ``expected``."""
    import contextlib
    import io

    for fn in COUNTERS.values():  # the main path starts here
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    torch.cuda.synchronize()
    launches = counts()  # ... and ends here
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    text = buf.getvalue()
    return {"seconds": time.perf_counter() - t0, "launches": launches, "text": text,
            "lines": [json.loads(line) for line in text.splitlines() if line.startswith("{")],
            "result": result}


def _step_trace(fn, images, expected, what):
    """One task train step ``fn``: its launches (counts 0 just before, read just after)
    against ``expected``, its peak memory, its ms (CUDA events over 3 steps), a
    profiler trace of 2 steps (device busy time, idle share, the port's kernels and the
    top kernels by device time)."""
    fn()
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    launches = counts()
    if launches != expected:
        raise AssertionError(f"{what} step: launches {launches}, expected {expected}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = cuda_ms(fn, iters=3, warmup=0)
    kernels = trace(fn, iters=2, warmup=0)
    busy = sum(k["ms"] for k in kernels)
    if busy > step_ms * 1.02:  # a trace that counts time twice gives no idle share
        raise AssertionError(f"{what}: device busy {busy} ms in a step of {step_ms} ms")
    ours = {kn: {"ms": sum(k["ms"] for k in kernels if kn in k["name"]),
                 "launches": sum(k["launches"] for k in kernels if kn in k["name"])}
            for kn in TASK_TRACE}
    return {"launches_per_step": {k: v for k, v in launches.items() if v},
            "peak_memory_gib": peak / 2**30, "step_ms": step_ms,
            "images_per_s": images / step_ms * 1e3, "device_busy_ms_per_step": busy,
            "device_idle_share": 1 - busy / step_ms, "port_kernels": ours,
            "top_kernels": kernels[:10]}


def phase_tasks_seg(work_dir: Path, init_ckpt: Path):
    """recnext_m3 Semantic FPN with the seg preset (crop 512, batch 16, fp32, FPN 256,
    150 classes, frozen backbone BN) through the train_seg CLI on FAKE: 3 iterations
    (mIoU at the 3rd, a checkpoint), a --resume to 6, --eval-only, --benchmark 5, each
    run from ``init_ckpt`` (a calibrated classifier, ``--init-ckpt``), each run's
    launches against the planners' (a step: K1 21 in the forward and 3 more that
    recompute the peeled levels' inner pyramids, 3 level-kernel launches, K1′ 21, KL′1-3
    6/6/3; a forward: K1 21); the backbone's running statistics the same bits after
    the 6 steps, the head's moved. Then one train step traced (ms, img/s, idle share,
    kernels, peak memory)."""
    from recnext_tpu_torch.tasks import train_seg

    fwd, step = m3_task_launches(SEG_SIDE)
    out = work_dir / "seg"
    base = ["--preset", SEG_PRESET, "--crop", str(SEG_SIDE), "--batch-size", str(TASK_BATCH),
            "--init-ckpt", str(init_ckpt), "--output-dir", str(out)]
    runs = {}
    for name, extra, want in (
            ("train_3", ["--iters", "3", "--eval-every", "3"], _added(_times(3, step), fwd)),
            ("resume_to_6", ["--iters", "6", "--eval-every", "3", "--resume"],
             _added(_times(3, step), fwd)),
            ("eval_only", ["--eval-only"], fwd),
            ("benchmark_5", ["--benchmark", "5"], _times(6, fwd))):
        run = _run_cli(train_seg.main, base + extra, want, f"train_seg {name}")
        runs[name] = {"seconds": run["seconds"], "lines": run["lines"],
                      "launches": {k: v for k, v in run["launches"].items() if v}}
        if name.startswith(("train", "resume")):
            last = run["lines"][-1]
            if not (np.isfinite(last["loss"]) and 0 <= last["mIoU"] <= 100):
                raise AssertionError(f"train_seg {name}: {last}")
            if name == "resume_to_6":
                if "resumed at iter 3" not in run["text"] or run["result"]["state"].step != 6:
                    raise AssertionError(f"train_seg {name} did not resume: {run['text']}")
                trained = run["result"]["state"].model
    args = train_seg.parse_args(base)
    fresh = train_seg.build_state(args, torch.device("cuda")).model.state_dict()
    moved = {"backbone": 0, "head": 0}
    for k, v in trained.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            same = torch.equal(v, fresh[k])
            if k.startswith("backbone.") != same:
                raise AssertionError(f"frozen BN: {k} {'unchanged' if same else 'moved'}")
            moved["head" if not same else "backbone"] += 1
    del trained, fresh
    runs["frozen_bn"] = {"backbone_statistics_same_bits": moved["backbone"],
                         "head_statistics_moved": moved["head"]}

    state = train_seg.build_state(args, torch.device("cuda"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_seg.synthetic_seg_batch(
        np.random.default_rng(0), TASK_BATCH, SEG_SIDE, 150).items()}
    gen = torch.Generator("cuda").manual_seed(0)
    train_step = train_seg.make_seg_train_step()
    traced = _step_trace(lambda: train_step(state, batch, gen), TASK_BATCH, step, "tasks_seg")
    del state
    emit({"phase": "tasks_seg", "model": "recnext_m3 Semantic FPN", "preset": SEG_PRESET,
          "input": [TASK_BATCH, 3, SEG_SIDE, SEG_SIDE], "dtype": "float32",
          "cudnn_tf32": torch.backends.cudnn.allow_tf32,
          "expected_per_forward": {k: v for k, v in fwd.items() if v},
          "expected_per_step": {k: v for k, v in step.items() if v}, "cli": runs,
          "step": traced})
    return step, traced


def phase_tasks_recconv():
    """K1 and K1′ one call at a time at recnext_m3's mixer shapes of the task paths,
    batch 16, fp32 (the seg path's four planes at 512^2, the detection path's at 800^2,
    whose stage 0 forward peels a level too): each held against its plain version on
    the inputs it is then timed on (K1 at 2e-5 max|ref| in f32 and 1e-2 on the inputs
    rounded to bf16, ``_check_recconv``; K1′'s dx at 2e-5 and dW at 1e-4,
    ``_check_backward``); device ms (CUDA events around queued calls) beside the bound
    and the plain version, and the sums over one forward (K1) and one train step (K1′)
    of each path. A peeled call's time counts every launch it makes (the level kernel,
    the recomputed pyramid, KL′1-3), its bound the function's bytes and operations."""
    gen = torch.Generator().manual_seed(14)
    planes = {path: [(-(-side // (4 << i)), 4 - i, d, c) for i, (d, c) in enumerate(M3_STAGES)]
              for path, side in (("seg", SEG_SIDE), ("det", DET_SIDE))}
    totals = {}
    for path, shapes in planes.items():
        tot = totals[path] = {k: dict.fromkeys(("kernel_ms", "plain_ms", "bytes", "flops"), 0.0)
                              for k in ("k1_forward", "k1_bwd_step")}
        for side, level, depth, c in shapes:
            x, ws = _recconv_inputs(gen, TASK_BATCH, c, side, side, level, torch.float32)
            g = torch.randn(x.shape, generator=gen).cuda()
            rec = {"phase": "tasks_recconv", "path": path, "shape": [TASK_BATCH, c, side, side],
                   "level": level, "mixers": depth, "dtype": "float32",
                   "forward_peel": recconv_cuda.levels_to_peel(side, side, level, 5, 4),
                   "backward_peel": recconv_bwd_cuda.levels_to_peel_backward(side, side,
                                                                             level, 5),
                   "k1_forward_check": _check_recconv(x, ws, level, "bilinear"),
                   "k1_bwd_err_over_max_ref": _check_backward(x, ws, g, level, "bilinear")[0]}
            for part, run, plain, work in (
                    ("k1_forward", lambda: rec_conv2d_fused(x, ws[0], ws[1:], level=level),
                     lambda: rec_conv2d(x, ws[0], ws[1:], level=level),
                     recconv_work(TASK_BATCH, c, side, side, level, 5, 4)),
                    ("k1_bwd_step", lambda: rec_conv2d_backward(x, ws[0], ws[1:], g, level=level),
                     lambda: rec_conv2d_backward_plain(x, ws[0], ws[1:], g, level=level),
                     recconv_bwd_work(TASK_BATCH, c, side, side, level, 5, 4))):
                times = {"kernel_ms": queued_ms(run), "plain_ms": queued_ms(plain, iters=3)}
                bms, by = bound(*work)
                rec[part] = dict(times, bound_ms=bms, bound_by=by, bytes=work[0], flops=work[1])
                for key, val in (*times.items(), ("bytes", work[0]), ("flops", work[1])):
                    tot[part][key] += depth * val
            emit(rec)
            del x, g
        for t in tot.values():
            t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
    emit({"phase": "tasks_recconv_totals", "batch": TASK_BATCH, "dtype": "float32", **totals})
    return totals


def tasks_level_kernel(x, w, inner, side):
    """K1's level kernel (``rec_conv2d_level``) at a task path's peeled plane, fp32:
    the stride-2 down conv and the upsample-add-conv (bilinear, the recipes' mode; and
    nearest, checked only), each against its plain version (2e-5 of max|ref|) and its
    own bits on three runs, timed beside its bound, its plain version and, for the down
    conv, ``F.conv2d(..., stride=2, groups=C)``. Returns the lines."""
    n, c = int(x.shape[0]), int(x.shape[1])
    lines = []
    for step, stride, up, mode in (("down", 2, None, "bilinear"),
                                   ("up_add_conv", 1, inner, "bilinear"),
                                   ("up_add_conv", 1, inner, "nearest")):
        kw = dict(stride=stride, up=up, mode=mode)
        before = COUNTERS["rec_conv2d_level"].launches
        got = rec_conv2d_level(x, w, **kw)
        if COUNTERS["rec_conv2d_level"].launches != before + 1:
            raise AssertionError(f"level kernel {step}: launches not counted")
        err, scale = _check_close(f"level kernel {step} {mode} at {side}^2", got,
                                  rec_conv2d_level_plain(x, w, **kw), 2e-5)
        if not all(torch.equal(rec_conv2d_level(x, w, **kw), got) for _ in range(2)):
            raise AssertionError(f"level kernel {step} {mode} at {side}^2: runs differ")
        if mode == "nearest":
            lines.append({"phase": "tasks_level_kernel", "step": step, "mode": mode,
                          "shape": [n, c, side, side], "max_abs_err": err,
                          "max_abs_ref": scale, "same_bits_on_3_runs": True})
            continue
        times = {"kernel_ms": queued_ms(lambda: rec_conv2d_level(x, w, **kw)),
                 "plain_ms": queued_ms(lambda: rec_conv2d_level_plain(x, w, **kw), iters=5),
                 "library_ms": queued_ms(lambda: F.conv2d(x, w, stride=2, padding=2, groups=c))
                 if up is None else None}
        nbytes, flops = level_work(n, c, side, side, 5, stride, up is not None, 4, 4)
        bms, by = bound(nbytes, flops)
        lines.append({"phase": "tasks_level_kernel", "step": step, "mode": mode,
                      "shape": [n, c, side, side], "max_abs_err": err, "max_abs_ref": scale,
                      "same_bits_on_3_runs": True, **times, "bound_ms": bms,
                      "bound_by": by, "over_bound": times["kernel_ms"] / bms, "bytes": nbytes,
                      "flops": flops,
                      **recconv_cuda.level_kernel_attributes(5, stride, torch.float32)})
    return lines


def phase_tasks_level_backward():
    """KL′1-3 alone at the task paths' peeled planes, fp32, batch 16: 128^2 x 64
    (stage 0 at 512^2) and 200^2 x 64 (stage 0 at 800^2), each against its plain
    version and its own bits on three runs, timed beside its bound, its plain version
    and one cuDNN/ATen call; the sums over one train step's 15 launches (3 peeled
    mixers). At each plane, one backward call of a level-4 mixer counts the launches
    that ``peeled_backward_launches`` expects; and K1's level kernel (down conv and
    upsample-add-conv) is timed there too (``tasks_level_kernel``)."""
    gen = torch.Generator().manual_seed(12)
    totals = {}
    for side in (SEG_SIDE // 4, DET_SIDE // 4):
        n, c, h, w = TASK_BATCH, 64, side, side
        x, g = torch.randn(n, c, h, w, generator=gen), torch.randn(n, c, h, w, generator=gen)
        ws = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(6)]
        want_launches = peeled_backward_launches(h, w, 4, 5)
        before = counts()
        rec_conv2d_backward(x.cuda(), ws[0].cuda(), [t.cuda() for t in ws[1:]], g.cuda(),
                            level=4)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        if got != want_launches:
            raise AssertionError(f"{side}^2 peeled backward launches {got}, want {want_launches}")
        summed = ("kernel_ms", "plain_ms", "library_ms", "bytes", "flops")
        tot = totals[side] = {k: dict.fromkeys(summed, 0.0) for k in LEVEL_BWD}
        for case in level_backward_cases(x, g, ws, gen, torch.float32):
            out = level_backward_case("tasks_level_backward", case, [n, c, h, w])
            out["launches_per_peeled_call"] = want_launches
            if "kernel_ms" in out:
                for key in summed:
                    tot[case[0]][key] += 3 * out[key]  # 3 peeled mixers a step
            emit(out)
        for t in tot.values():
            t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
        inner = torch.randn(n, c, (h + 1) // 2, (w + 1) // 2, generator=gen).cuda()
        for line in tasks_level_kernel(x.cuda(), ws[-1].cuda(), inner, side):
            emit(line)
        del x, g, inner
    emit({"phase": "tasks_level_backward_step", "batch": TASK_BATCH, "dtype": "float32",
          "per_plane_side": totals})
    return totals


def _capture_kernel_calls(name):
    """Record each call that the model's mixers make of their forward kernel (K1 for
    the M family, K2 for the A family), its inputs and the gradient that reaches its
    output, by wrapping the entry ``models/mixers.py`` calls. Returns the records and
    a function that restores the entry."""
    from recnext_tpu_torch.models import mixers

    entry = "rec_conv2d_fused" if name.startswith("recnext_m") else "linear_attention_nchw"
    original, calls = getattr(mixers, entry), []

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        rec = {"args": [a.detach() if isinstance(a, torch.Tensor) else
                        [t.detach() for t in a] if isinstance(a, list) else a for a in args],
               "kwargs": kwargs}
        calls.append(rec)
        out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return out

    setattr(mixers, entry, wrapper)
    return calls, lambda: setattr(mixers, entry, original)


def _check_captured_backward(name, calls):
    """Each captured call's backward kernel (K1′ or K2′) against its plain version on the
    inputs and output gradient it saw in the model's step, at K1′'s bounds (dx 2e-5,
    dW 1e-4 max|ref|) or K2′'s (2e-5 max|ref|). Returns the worst error over max|ref|."""
    worst = 0.0
    for call in calls:
        if name.startswith("recnext_m"):
            x, down, convs = call["args"][:3]
            errs, _ = _check_backward(x, [down, *convs], call["g"], call["kwargs"]["level"],
                                      call["kwargs"].get("mode", "bilinear"))
            worst = max([worst, *errs.values()])
        else:
            qk, v, nh = call["args"][:3]
            d = qk.shape[1] // (2 * nh)

            def heads(t, r):  # (B, nh*R, H, W) -> (B*nh, N, R)
                return t.reshape(t.shape[0] * nh, r, -1).transpose(1, 2)

            dqk, dv = linear_attention_nchw_backward(qk, v, call["g"], nh)
            want = linear_attention_backward_plain(
                heads(qk[:, : nh * d].float(), d), heads(qk[:, nh * d:].float(), d),
                heads(v.float(), v.shape[1] // nh), heads(call["g"].float(), v.shape[1] // nh))
            got = (heads(dqk[:, : nh * d], d), heads(dqk[:, nh * d:], d),
                   heads(dv, v.shape[1] // nh))
            _, rels = _check_attention_grads(got, want, torch.float32, (name, tuple(qk.shape)))
            worst = max([worst, *(r for r in rels.values() if r is not None)])
    return worst


def _pin_head_relus(model, masks, flips):
    """Make each ``ScaleHeadStep`` of ``model`` apply its ReLU as the on/off pattern
    ``masks[i]`` (step i in module order; recorded from this forward where ``masks`` is
    empty), and append to ``flips`` the number of the ReLU's inputs whose sign
    disagrees with the pattern. y * mask has ReLU's value and gradient where the
    pattern is y's own."""
    from recnext_tpu_torch.tasks.segmentation import ScaleHeadStep

    record = not masks

    def pinned(step, i):
        def forward(x):
            y = step.bn(step.conv(x))
            if record:
                masks[i] = y > 0
            else:
                flips.append(int(((y > 0) != masks[i]).sum()))
            x = y * masks[i].to(y.dtype)
            if step.up:
                x = resize(x, (x.shape[2] * 2, x.shape[3] * 2), mode="bilinear")
            return x
        return forward

    for i, step in enumerate(m for m in model.modules() if isinstance(m, ScaleHeadStep)):
        step.forward = pinned(step, i)


TASK_GRAD_TOL = 1e-4  # each gradient's error over its max, beyond 10x the plain path's


def phase_tasks_grad(init_ckpt: Path, name="recnext_m3", batch=2):
    """``name``'s Semantic FPN (frozen backbone BN, the backbone from ``init_ckpt``) at
    batch x side^2 in train mode, with the same dropout mask on every path: the kernel
    path in fp32 against the plain path in fp32 and in float64 (the exact gradients),
    the counts set to 0 just before each path and read just after. The head's ReLUs
    take the float64 path's on/off pattern on every path (``_pin_head_relus``): an
    fp32 path's features differ from float64's by ~1e-6 relative, enough to put a few
    of the head's ReLU inputs on the other side of 0, and each such flip moves a head
    conv's gradient by one position's term, up to 5e-3 of its max at batch 2. Checked:
    the logits within 1e-4 max|ref| (phase 4's f32 bound), the loss within 1e-5; each
    of the step's backward-kernel calls (as many as the model's mixers) against its
    plain version on the inputs and output gradient it saw, at K1′'s or K2′'s bounds;
    every parameter's gradient off the exact one by at most max(10x the plain path's
    error, ``TASK_GRAD_TOL``) of the exact one's max. The flips and the errors of
    both fp32 paths with their own ReLUs (unpinned) are printed beside them."""
    import copy

    from recnext_tpu_torch.models.registry import get_config
    from recnext_tpu_torch.tasks.detection import (init_backbone_from_classification,
                                                   init_task_weights)
    from recnext_tpu_torch.tasks.segmentation import SemanticFPN, segmentation_loss

    side = SEG_SIDE
    cfg = get_config(name, num_classes=0)
    model = SemanticFPN(cfg, num_classes=150)
    init_task_weights(model, torch.Generator().manual_seed(3))
    model.load_state_dict(init_backbone_from_classification(
        model.state_dict(), read_weights(str(init_ckpt), log=lambda m: None)), strict=True)
    model.cuda().train()
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(batch, 3, side, side, generator=gen).cuda()
    y = torch.randint(0, 150, (batch, side, side), generator=gen).cuda()
    expected = m3_task_launches(side)[1] if name == "recnext_m3" else a3_task_launches()
    masks, flips, got = {}, {}, {}
    for path, dtype in (("plain_path_f64", torch.float64), ("kernel_path", torch.float32),
                        ("plain_path", torch.float32), ("kernel_path_unpinned", torch.float32),
                        ("plain_path_unpinned", torch.float32)):
        m = copy.deepcopy(model).to(dtype)
        m.decode_head.generator = torch.Generator("cuda").manual_seed(5)
        kernel = path.startswith("kernel")
        restore = None if kernel else plain_path(m)
        if not path.endswith("unpinned"):
            _pin_head_relus(m, masks, flips.setdefault(path, []))
        if path == "kernel_path":
            calls, unwrap = _capture_kernel_calls(name)
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        logits = m(x.to(dtype))
        loss = (F.cross_entropy(logits, y)  # float64 (segmentation_loss casts to fp32)
                if dtype == torch.float64 else segmentation_loss(logits, y))
        loss.backward()
        torch.cuda.synchronize()
        launches = counts()  # ... and ends here
        if path == "kernel_path":
            unwrap()
        if restore:
            restore()
        want = expected if kernel else dict.fromkeys(COUNTERS, 0)
        if launches != want:
            raise AssertionError(f"tasks_grad {name} {path}: launches {launches}, want {want}")
        got[path] = (logits.detach().float(), loss.item(),
                     {n: p.grad.double() for n, p in m.named_parameters()})
        del m
    _, loss_64, g64 = got["plain_path_f64"]
    (lk, loss_k, _), (lp, loss_p, _) = got["kernel_path"], got["plain_path"]
    logit_err, logit_scale = (lk - lp).abs().max().item(), lp.abs().max().item()
    if not (logit_err <= 1e-4 * logit_scale and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)):
        raise AssertionError(f"tasks_grad {name}: logits {logit_err} of {logit_scale}, "
                             f"loss {loss_k} vs {loss_p}")
    if len(calls) != sum(cfg.depth) or not all("g" in c for c in calls):
        raise AssertionError(f"tasks_grad {name}: {len(calls)} kernel calls captured, "
                             f"{sum(cfg.depth)} mixers")
    backward_worst = _check_captured_backward(name, calls)
    errs = {path: {n: (grads[n] - g).abs().max().item() / g.abs().max().item()
                   for n, g in g64.items() if g.abs().max().item() >= 1e-6}
            for path, (_, _, grads) in got.items() if path != "plain_path_f64"}
    if not all(torch.isfinite(g).all() for _, _, grads in got.values() for g in grads.values()):
        raise AssertionError(f"tasks_grad {name}: a gradient is not finite")
    over = {n: (e, errs["plain_path"][n]) for n, e in errs["kernel_path"].items()
            if not e <= max(10 * errs["plain_path"][n], TASK_GRAD_TOL)}
    if over:
        raise AssertionError(f"tasks_grad {name}: gradients off the exact ones (kernel path, "
                             f"plain path): {over}")
    rec = {"phase": "tasks_grad", "model": f"{name} Semantic FPN",
           "input": [batch, 3, side, side], "launches": {k: v for k, v in expected.items() if v},
           "loss": {"kernel_path": loss_k, "plain_path": loss_p, "plain_path_f64": loss_64},
           "logits_max_abs_err": logit_err, "logits_max_abs": logit_scale,
           "backward_calls_checked": len(calls),
           "backward_worst_err_over_max_ref": backward_worst,
           "gradients_worst_err_over_max_exact": {
               path: max((e, n) for n, e in es.items()) for path, es in errs.items()},
           "gradient_tol": {"times_plain": 10, "floor": TASK_GRAD_TOL},
           "head_relu_inputs_flipped_against_f64": {p: sum(f) for p, f in flips.items()
                                                    if p != "plain_path_f64"},
           "head_relu_inputs": sum(int(mk.numel()) for mk in masks.values()),
           "parameters": len(g64)}
    emit(rec)
    return rec


def phase_tasks_det(work_dir: Path, init_ckpt: Path):
    """recnext_m3 RetinaNet with the detection preset (800^2, batch 16, fp32, FPN 256
    P2-P6, 80 classes, backbone BN training as the JAX CLI builds it) through the
    train_det CLI on FAKE: 2 epochs of 3 steps and the AP loop over 16 images, a
    --resume to 3 epochs, --eval-only over 16 images and --benchmark 3, each run's
    launches against the planners' (a forward: K1 21 and 6 level-kernel launches; a
    step: that and the backward's). Then one train step traced, and the post-process's
    ms per image (the predict call less the forward, batch 16)."""
    from recnext_tpu_torch.tasks import train_det
    from recnext_tpu_torch.tasks.detection import generate_anchors

    fwd, step = m3_task_launches(DET_SIDE)
    out = work_dir / "det"
    base = ["--preset", DET_PRESET, "--detector", "retinanet", "--batch-size", str(DET_BATCH),
            "--img-size", str(DET_SIDE), "--init-ckpt", str(init_ckpt),
            "--steps-per-epoch", "3", "--fake-size", "16", "--eval-max-images", "16",
            "--output-dir", str(out)]
    evals = 16 // DET_BATCH
    runs = {}
    for name, extra, want in (
            ("train_2x3", ["--epochs", "2", "--eval-every", "2"],
             _added(_times(6, step), _times(evals, fwd))),
            ("resume_to_3", ["--epochs", "3", "--eval-every", "0", "--resume"],
             _times(3, step)),
            ("eval_only", ["--eval-only"], _times(evals, fwd)),
            ("benchmark_3", ["--benchmark", "3"], _times(4, fwd))):
        run = _run_cli(train_det.main, base + extra, want, f"train_det {name}")
        runs[name] = {"seconds": run["seconds"], "lines": run["lines"],
                      "launches": {k: v for k, v in run["launches"].items() if v}}
        if name.startswith(("train", "resume")):
            if not all(np.isfinite(r["train_loss"]) for r in run["lines"]):
                raise AssertionError(f"train_det {name}: {run['lines']}")
            if name == "resume_to_3" and ("resumed from epoch 1" not in run["text"]
                                          or run["result"]["state"].step != 9):
                raise AssertionError(f"train_det {name} did not resume: {run['text']}")
        if name in ("train_2x3", "eval_only") and "bbox_mAP" not in run["lines"][-1]:
            raise AssertionError(f"train_det {name}: no AP in {run['lines']}")

    args = train_det.parse_args(["--preset", DET_PRESET, "--detector", "retinanet"])
    from recnext_tpu_torch.models.registry import get_config
    from recnext_tpu_torch.tasks.detection import (RetinaNet, init_backbone_from_classification,
                                                   init_task_weights,
                                                   make_detection_train_step)
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState

    model = RetinaNet(get_config(args.backbone, num_classes=0), num_classes=80,
                      frozen_backbone_stats=False)
    init_task_weights(model, torch.Generator().manual_seed(0))
    model.load_state_dict(init_backbone_from_classification(
        model.state_dict(), read_weights(str(init_ckpt), log=lambda m: None)), strict=True)
    model.cuda()
    shapes = train_det.pyramid_shapes(DET_SIDE)
    anchors = torch.from_numpy(generate_anchors(shapes, strides=train_det.STRIDES)).cuda()
    opt = make_optimizer(model.named_parameters(), train_det.step_lr(2e-4, 1000), 0.05,
                         agc_clip=0.0, decay_all=True)
    state = TrainState.create(model, opt, ema=False)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_det.synthetic_det_batch(
        np.random.default_rng(0), DET_BATCH, DET_SIDE, 80).items()}
    train_step = make_detection_train_step(anchors, 80)
    traced = _step_trace(lambda: train_step(state, batch), DET_BATCH, step, "tasks_det")
    predict = train_det.make_predict_fn(model, anchors, [h * w * 9 for h, w in shapes], 0.05)
    x = batch["image"]

    def forward():
        with torch.no_grad():
            model.eval()(x)

    predict_ms, forward_ms = cuda_ms(lambda: predict(x), iters=3, warmup=1), cuda_ms(forward, 3, 1)
    del state, model
    emit({"phase": "tasks_det", "model": "recnext_m3 RetinaNet", "preset": DET_PRESET,
          "input": [DET_BATCH, 3, DET_SIDE, DET_SIDE], "dtype": "float32",
          "cudnn_tf32": torch.backends.cudnn.allow_tf32,
          "pyramid": shapes, "anchors": int(anchors.shape[0]),
          "expected_per_forward": {k: v for k, v in fwd.items() if v},
          "expected_per_step": {k: v for k, v in step.items() if v}, "cli": runs,
          "step": traced, "predict_ms_per_batch": predict_ms, "forward_ms_per_batch": forward_ms,
          "postprocess_ms_per_image": (predict_ms - forward_ms) / DET_BATCH})
    return step, traced


MRCNN_EVAL_IMAGES = 16  # the AP loop's images (one batch of 16)


def _mask_rcnn_model(init_ckpt: Path, seed: int):
    """recnext_m3 Mask R-CNN as the det preset's CLI builds it (80 classes, FPN 256, 128
    proposals, the mask head, backbone BN training), the backbone from ``init_ckpt``, on
    the card."""
    from recnext_tpu_torch.tasks import train_det
    from recnext_tpu_torch.tasks.detection import init_backbone_from_classification

    args = train_det.parse_args(["--preset", DET_PRESET, "--with-mask"])
    model = train_det.build_model(args, True, torch.Generator().manual_seed(seed))
    model.load_state_dict(init_backbone_from_classification(
        model.state_dict(), read_weights(str(init_ckpt), log=lambda m: None)), strict=True)
    return model.cuda()


def _mask_rcnn_stages(model, batch):
    """Device ms (CUDA events) of a train step's stages outside the backbone, on the
    step's own inputs: the proposals (top 1000 of 159,882 anchors, decode, NMS to 128,
    batched), the two RoIAligns (7^2 and 14^2, one gather each from the levels packed
    channels-last) forward and backward, the RoI stage (both RoIAligns, the box head
    on 7^2 RoIs, the mask head on 14^2) forward and forward + backward, the loss
    forward + backward."""
    from recnext_tpu_torch.tasks.mask_rcnn import (ROI_STRIDES, mask_rcnn_loss, splice_gt)
    from recnext_tpu_torch.tasks.roi import multilevel_roi_align, pack_levels

    model.train()
    hw = tuple(batch["image"].shape[2:])
    with torch.no_grad():
        feats, obj, deltas, anchors = model._rpn(batch["image"])
        props = splice_gt(*model._propose(obj, deltas, anchors, hw), batch["gt_boxes"],
                          batch["gt_labels"])
    leaves = [f.detach().requires_grad_() for f in feats]

    def roi_align():
        packed = pack_levels(leaves[:4])
        a, b = (multilevel_roi_align(leaves[:4], props[0], ROI_STRIDES, s, packed=packed)
                for s in (7, 14))
        (a.sum() + b.sum()).backward()

    def heads(backward):
        def run():
            with torch.set_grad_enabled(backward):
                out = model._roi_heads(leaves, props[0])
                if backward:
                    sum(v.sum() for v in out.values()).backward()
        return run

    out = {k: (v.detach().requires_grad_() if v.is_floating_point() and k != "anchors"
               and not k.startswith("proposals") else v)
           for k, v in model(batch["image"], batch["gt_boxes"], batch["gt_labels"]).items()}

    def loss():
        mask_rcnn_loss(out, batch, num_classes=80).backward()

    times = {"proposals_ms": cuda_ms(lambda: model._propose(obj, deltas, anchors, hw), 5, 1),
             "roi_align_fwd_bwd_ms": cuda_ms(roi_align, 3, 1),
             "roi_stage_fwd_ms": cuda_ms(heads(False), 3, 1),
             "roi_stage_fwd_bwd_ms": cuda_ms(heads(True), 3, 1),
             "loss_fwd_bwd_ms": cuda_ms(loss, 3, 1)}
    model.zero_grad(set_to_none=True)
    return times


def phase_tasks_mask_rcnn(work_dir: Path, init_ckpt: Path):
    """recnext_m3 Mask R-CNN with the detection preset (800^2, batch 16, fp32, FPN 256
    P2-P6, 80 classes, 128 proposals an image, the mask head, backbone BN training as
    the JAX CLI builds it) through the train_det CLI (--detector mask_rcnn --with-mask)
    on FAKE: one epoch of 3 steps and the AP loop over 16 images (bbox and segm AP),
    --eval-only over 16 images and --benchmark 3, each run's launches against the
    planners' (a forward: K1 21 and 6 level-kernel launches; a step: that and the
    backward's), finite loss terms. Then one train step traced (ms, img/s, idle share,
    peak memory, the port's kernels and their share, the top kernels), its stages
    outside the backbone (``_mask_rcnn_stages``), and the predict call: ms a batch,
    the backbone + FPN + RPN forward's ms, and the post-process (proposals, box head,
    NMS, mask head) and ``paste_masks`` ms an image, every image's 100 detections
    pasted (scores from 0: an untrained head's sit under the CLI's 0.05)."""
    from recnext_tpu_torch.tasks import train_det
    from recnext_tpu_torch.tasks.mask_rcnn import make_mask_rcnn_train_step, paste_masks
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState

    fwd, step = m3_task_launches(DET_SIDE)
    base = ["--preset", DET_PRESET, "--detector", "mask_rcnn", "--with-mask",
            "--batch-size", str(DET_BATCH), "--img-size", str(DET_SIDE),
            "--init-ckpt", str(init_ckpt), "--steps-per-epoch", "3",
            "--fake-size", str(MRCNN_EVAL_IMAGES), "--eval-max-images", str(MRCNN_EVAL_IMAGES),
            "--output-dir", str(work_dir / "mask_rcnn")]
    evals = MRCNN_EVAL_IMAGES // DET_BATCH
    parts = ("train_loss", "loss_rpn", "loss_roi", "loss_mask")
    runs = {}
    for name, extra, want in (
            ("train_1x3", ["--epochs", "1", "--eval-every", "1"],
             _added(_times(3, step), _times(evals, fwd))),
            ("eval_only", ["--eval-only"], _times(evals, fwd)),
            ("benchmark_3", ["--benchmark", "3"], _times(4, fwd))):
        run = _run_cli(train_det.main, base + extra, want, f"train_det mask_rcnn {name}")
        runs[name] = {"seconds": run["seconds"], "lines": run["lines"],
                      "launches": {k: v for k, v in run["launches"].items() if v}}
        last = run["lines"][-1]
        if name == "train_1x3" and not all(np.isfinite(last[k]) for k in parts):
            raise AssertionError(f"train_det mask_rcnn {name}: {last}")
        if name != "benchmark_3" and not {"bbox_mAP", "segm_mAP"} <= set(last):
            raise AssertionError(f"train_det mask_rcnn {name}: no bbox/segm AP in {last}")

    model = _mask_rcnn_model(init_ckpt, 0)
    opt = make_optimizer(model.named_parameters(), train_det.step_lr(2e-4, 1000), 0.05,
                         agc_clip=0.0, decay_all=True)
    state = TrainState.create(model, opt, ema=False)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_det.synthetic_det_batch(
        np.random.default_rng(0), DET_BATCH, DET_SIDE, 80, with_masks=True).items()}
    train_step = make_mask_rcnn_train_step(80)
    traced = _step_trace(lambda: train_step(state, batch), DET_BATCH, step, "tasks_mask_rcnn")
    ours = sum(k["ms"] for k in traced["port_kernels"].values())
    traced["port_kernels_ms"], traced["port_kernels_share_of_step"] = ours, ours / traced["step_ms"]
    stages = _mask_rcnn_stages(model, batch)

    predict = train_det.make_mask_rcnn_predict_fn(model, 0.0)
    x = batch["image"]

    def forward():
        with torch.no_grad():
            model.eval()._rpn(x)

    predict_ms, forward_ms = cuda_ms(lambda: predict(x), 3, 1), cuda_ms(forward, 3, 1)
    boxes, scores, labels, masks, valid = (t.cpu().numpy() for t in predict(x))
    t0 = time.perf_counter()
    pasted = [paste_masks(masks[b][valid[b]], boxes[b][valid[b]], (DET_SIDE, DET_SIDE), 1.0)
              for b in range(DET_BATCH)]
    paste_ms = (time.perf_counter() - t0) * 1e3 / DET_BATCH
    detections = int(valid.sum())
    if not detections or any(p.shape != (v.sum(), DET_SIDE, DET_SIDE)
                             for p, v in zip(pasted, valid)):
        raise AssertionError(f"tasks_mask_rcnn predict: {detections} detections pasted")
    del state, model, pasted
    torch.cuda.empty_cache()
    post_ms = (predict_ms - forward_ms) / DET_BATCH
    rec = {"phase": "tasks_mask_rcnn", "model": "recnext_m3 Mask R-CNN", "preset": DET_PRESET,
           "input": [DET_BATCH, 3, DET_SIDE, DET_SIDE], "dtype": "float32",
           "cudnn_tf32": torch.backends.cudnn.allow_tf32, "proposals": 128,
           "anchors": int(sum(h * w * 3 for h, w in train_det.pyramid_shapes(DET_SIDE))),
           "expected_per_forward": {k: v for k, v in fwd.items() if v},
           "expected_per_step": {k: v for k, v in step.items() if v}, "cli": runs,
           "step": traced, "stages": stages, "predict_ms_per_batch": predict_ms,
           "forward_ms_per_batch": forward_ms, "postprocess_ms_per_image": post_ms,
           "paste_masks_ms_per_image": paste_ms,
           "postprocess_and_paste_ms_per_image": post_ms + paste_ms,
           "detections_pasted": detections}
    emit(rec)
    return step, rec


def _pin_mask_rcnn_relus(masks, flips):
    """Make the Mask R-CNN heads' ReLUs (``tasks/mask_rcnn.py``'s ``F.relu``: the RPN's
    conv, the box head's fc1 and fc2, the mask head's convs) apply the on/off pattern
    ``masks[i]`` of their i-th call (recorded from this forward where ``masks`` is
    empty), and append to ``flips`` the number of inputs whose sign disagrees with it;
    as ``_pin_head_relus``. Returns a function that restores them."""
    from types import SimpleNamespace

    from recnext_tpu_torch.tasks import mask_rcnn

    record, calls = not masks, iter(range(1 << 30))

    def relu(y):
        i = next(calls)
        if record:
            masks[i] = y > 0
        else:
            flips.append(int(((y > 0) != masks[i]).sum()))
        return y * masks[i].to(y.dtype)

    original = mask_rcnn.F
    mask_rcnn.F = SimpleNamespace(relu=relu, interpolate=F.interpolate)
    return lambda: setattr(mask_rcnn, "F", original)


def phase_tasks_mask_rcnn_grad(init_ckpt: Path, batch=2):
    """recnext_m3 Mask R-CNN at batch x 800^2 in train mode (the det preset's model,
    the backbone from ``init_ckpt``) with the same proposals on every path (the kernel
    path's RPN's, fed through ``_propose``) and the heads' ReLUs pinned to the float64
    path's pattern (``_pin_mask_rcnn_relus``): the kernel path in fp32 against the
    plain path in fp32 and in float64, as ``phase_tasks_grad`` holds Semantic FPN.
    Checked: the launches (the kernel path's a step's, the plain paths' none); the RPN's
    objectness, the box head's logits and deltas and the mask logits within 1e-4 max|ref|
    of the plain path's, the loss within 1e-5; each of the step's K1′ calls against its
    plain version; every parameter's gradient off the exact one by at most max(10x the
    plain path's error, ``TASK_GRAD_TOL``) of its max."""
    import copy

    from recnext_tpu_torch.tasks import train_det
    from recnext_tpu_torch.tasks.mask_rcnn import mask_rcnn_loss

    side = DET_SIDE
    model = _mask_rcnn_model(init_ckpt, 3).train()
    data = {k: torch.from_numpy(v).cuda() for k, v in train_det.synthetic_det_batch(
        np.random.default_rng(4), batch, side, 80, with_masks=True).items()}
    with torch.no_grad():
        probe = copy.deepcopy(model)
        proposals = probe._propose(*probe._rpn(data["image"])[1:], (side, side))
        del probe
    expected = m3_task_launches(side)[1]
    masks, flips, got = {}, {}, {}
    keys = ("rpn_obj", "roi_cls", "roi_reg", "mask_logits")
    for path, dtype in (("plain_path_f64", torch.float64), ("kernel_path", torch.float32),
                        ("plain_path", torch.float32)):
        m = copy.deepcopy(model).to(dtype)
        m._propose = lambda *args: proposals
        kernel = path.startswith("kernel")
        restore = None if kernel else plain_path(m)
        unpin = _pin_mask_rcnn_relus(masks, flips.setdefault(path, []))
        if kernel:
            calls, unwrap = _capture_kernel_calls("recnext_m3")
        b = {**data, "image": data["image"].to(dtype), "gt_boxes": data["gt_boxes"].to(dtype)}
        for fn in COUNTERS.values():  # the main path starts here
            fn.launches = 0
        out = m(b["image"], b["gt_boxes"], b["gt_labels"])
        loss = mask_rcnn_loss(out, b, num_classes=80)
        loss.backward()
        torch.cuda.synchronize()
        launches = counts()  # ... and ends here
        unpin()
        if kernel:
            unwrap()
        if restore:
            restore()
        want = expected if kernel else dict.fromkeys(COUNTERS, 0)
        if launches != want:
            raise AssertionError(f"tasks_mask_rcnn_grad {path}: launches {launches}, "
                                 f"want {want}")
        got[path] = ({k: out[k].detach().float() for k in keys}, loss.item(),
                     {n: p.grad.double() for n, p in m.named_parameters()})
        del m, out, loss
    _, loss_64, g64 = got["plain_path_f64"]
    (ok, loss_k, _), (op, loss_p, _) = got["kernel_path"], got["plain_path"]
    outputs = {k: ((ok[k] - op[k]).abs().max().item(), op[k].abs().max().item()) for k in keys}
    bad = {k: v for k, v in outputs.items() if not v[0] <= 1e-4 * v[1]}
    if bad or not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"tasks_mask_rcnn_grad: outputs {bad}, loss {loss_k} vs {loss_p}")
    if len(calls) != 21 or not all("g" in c for c in calls):
        raise AssertionError(f"tasks_mask_rcnn_grad: {len(calls)} kernel calls captured")
    backward_worst = _check_captured_backward("recnext_m3", calls)
    errs = {path: {n: (grads[n] - g).abs().max().item() / g.abs().max().item()
                   for n, g in g64.items() if g.abs().max().item() >= 1e-6}
            for path, (_, _, grads) in got.items() if path != "plain_path_f64"}
    if not all(torch.isfinite(g).all() for _, _, grads in got.values() for g in grads.values()):
        raise AssertionError("tasks_mask_rcnn_grad: a gradient is not finite")
    over = {n: (e, errs["plain_path"][n]) for n, e in errs["kernel_path"].items()
            if not e <= max(10 * errs["plain_path"][n], TASK_GRAD_TOL)}
    if over:
        raise AssertionError(f"tasks_mask_rcnn_grad: gradients off the exact ones (kernel "
                             f"path, plain path): {over}")
    rec = {"phase": "tasks_mask_rcnn_grad", "model": "recnext_m3 Mask R-CNN",
           "input": [batch, 3, side, side], "proposals_valid": int(proposals[1].sum()),
           "launches": {k: v for k, v in expected.items() if v},
           "loss": {"kernel_path": loss_k, "plain_path": loss_p, "plain_path_f64": loss_64},
           "outputs_max_abs_err_and_max_abs": outputs,
           "backward_calls_checked": len(calls),
           "backward_worst_err_over_max_ref": backward_worst,
           "gradients_worst_err_over_max_exact": {
               path: max((e, n) for n, e in es.items()) for path, es in errs.items()},
           "gradient_tol": {"times_plain": 10, "floor": TASK_GRAD_TOL},
           "head_relu_inputs_flipped_against_f64": {p: sum(f) for p, f in flips.items()
                                                    if p != "plain_path_f64"},
           "head_relu_inputs": sum(int(mk.numel()) for mk in masks.values()),
           "parameters": len(g64)}
    emit(rec)
    return rec


def phase_tasks_attention():
    """K2 and K2′ at recnext_a3's four attention shapes at 512^2 (D 32; N 4096, 1024,
    256, 64; heads 2, 4, 8, 16; the last qk-first), batch 16 (the seg preset's), against
    their plain versions at phases 7 and 15's bounds in f32 and bf16, K2′ the same bits
    on three runs, each shape's K2′ route; device times in f32 (the task recipe's dtype;
    CUDA events around queued calls) beside bound and plain version, and the sums over
    one a3 forward (K2) and train step (K2′). A kernel slower than its plain version
    fails the phase but at the shapes named in ``A3_SLOWER_THAN_PLAIN``, which are
    printed as such."""
    gen = torch.Generator().manual_seed(13)
    d = A3_HEAD_DIM
    totals = {"forward": dict.fromkeys(("kernel_ms", "plain_ms", "bytes", "flops"), 0.0),
              "backward": dict.fromkeys(("kernel_ms", "plain_ms", "bytes", "flops"), 0.0)}
    max_abs_err = {"forward": 0.0, "backward": 0.0}

    def heads(t, nh):  # (B, nh*R, H, W) -> (B*nh, N, R)
        b, c, h, w = t.shape
        return t.reshape(b * nh, c // nh, h * w).transpose(1, 2)

    for stage, (nh, side, variant) in A3_ATTENTION.items():
        b, n = TASK_BATCH, side * side
        qk0 = torch.randn(b, 2 * nh * d, side, side, generator=gen).abs() + 0.1
        v0, g0 = (torch.randn(b, nh * d, side, side, generator=gen) for _ in range(2))
        cfg = attention_bwd_cuda.launch_config(n, d, d, 4, "n")
        rec = {"phase": "tasks_attention", "model": "recnext_a3", "stage": stage,
               "batch": b, "heads": nh, "n": n, "d": d, "variant": variant,
               "k2_bwd_route": cfg.route,
               "k2_bwd_launch": {k: v for k, v in cfg._asdict().items() if k != "geometry"}}
        for dtype in (torch.float32, torch.bfloat16):
            key = "f32" if dtype == torch.float32 else "bf16"
            qk, v, g = (t.to("cuda", dtype) for t in (qk0, v0, g0))
            want = linear_attention_nchw_plain(qk.float(), v.float(), nh, variant=variant)
            got = linear_attention_nchw(qk, v, nh, variant=variant).float()
            torch.cuda.synchronize()
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            ok = (bool(((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all())
                  if dtype == torch.float32 else err <= 1e-2 * scale)
            if not ok:
                raise AssertionError(f"K2 {key} at a3 stage {stage}: {err} (max|ref| {scale})")
            rec[f"k2_{key}_max_abs_err"] = err
            q, k = (heads(t.float(), nh) for t in (qk[:, : nh * d], qk[:, nh * d:]))
            bwant = linear_attention_backward_plain(q, k, heads(v.float(), nh),
                                                    heads(g.float(), nh))
            runs = [linear_attention_nchw_backward(qk, v, g, nh) for _ in range(3)]
            torch.cuda.synchronize()
            dqk, dv = runs[0]
            bgot = (heads(dqk[:, : nh * d], nh), heads(dqk[:, nh * d:], nh), heads(dv, nh))
            errs, rels = _check_attention_grads(bgot, bwant, dtype, ("a3", stage, key))
            if not all(torch.equal(a, b_) for r in runs[1:] for a, b_ in zip(r, runs[0])):
                raise AssertionError(f"K2' at a3 stage {stage} {key}: runs differ")
            rec[f"k2_bwd_{key}_max_abs_err"], rec[f"k2_bwd_{key}_err_over_max_ref"] = errs, rels
            rec[f"k2_bwd_{key}_same_bits_3_runs"] = True
            if dtype == torch.bfloat16:
                max_abs_err["forward"] = max(max_abs_err["forward"], err)
                max_abs_err["backward"] = max(max_abs_err["backward"], *errs.values())
        qk, v, g = (t.cuda() for t in (qk0, v0, g0))  # timed in f32, the recipe's dtype
        q, k = heads(qk[:, : nh * d], nh), heads(qk[:, nh * d:], nh)
        timed = {
            "forward": ({"kernel_ms": queued_ms(lambda: linear_attention_nchw(
                qk, v, nh, variant=variant)), "plain_ms": queued_ms(
                lambda: linear_attention_nchw_plain(qk, v, nh, variant=variant), iters=5)},
                attention_work(b, nh, n, d, d, 4)),
            "backward": ({"kernel_ms": queued_ms(lambda: linear_attention_nchw_backward(
                qk, v, g, nh)), "plain_ms": queued_ms(lambda: linear_attention_backward_plain(
                q, k, heads(v, nh), heads(g, nh)), iters=5)},
                attention_bwd_work(b, nh, n, d, d, 4))}
        for part, (times, (nbytes, flops)) in timed.items():
            bms, by = bound(nbytes, flops)
            slower = times["kernel_ms"] > times["plain_ms"]
            if slower and (part, n) not in A3_SLOWER_THAN_PLAIN:
                raise AssertionError(f"tasks_attention: {part} kernel slower than its plain "
                                     f"version at a3 stage {stage}: {times}")
            rec[f"{part}_f32_batch_{b}"] = dict(
                times, bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
                kernel_over_plain=times["kernel_ms"] / times["plain_ms"],
                slower_than_plain="known (A3_SLOWER_THAN_PLAIN)" if slower else False)
            for key, val in (*times.items(), ("bytes", nbytes), ("flops", flops)):
                totals[part][key] += A3_DEPTHS[stage] * val
        emit(rec)
    for t in totals.values():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
    emit({"phase": "tasks_attention_totals", "model": "recnext_a3", "batch": TASK_BATCH,
          "dtype": "float32", "calls": sum(A3_DEPTHS), **totals})
    return totals, max_abs_err


# the export, train-flag and two-process paths (PR 19's slice): m1 and a1 exported by
# the export CLI and run from a fresh process; the trainer's remaining flags; the m1
# train step as two processes on the one card (gloo on CUDA tensors)
EXPORT_BATCHES = (8, 256)
FLAGS_ARGS = ["--model", "recnext_m1", "--data-set", "FAKE", "--simple-aug", "--input-size",
              "224", "--batch-size", "32", "--steps-per-epoch", "2", "--log-every", "1"]
FLAGS_STEPS, FLAGS_EVALS = 2, 2  # a run's steps an epoch; eval forwards (--eval-ema: 1)
TWO_PROCESS_BATCH, TWO_PROCESS_TIMED = 64, 3  # the global batch; timed steps a process


def _export_check(model_dirs):
    """In a fresh process (spawned, so nothing of the parent's state): each exported
    program loaded by torch.export.load, run on the card beside the eager fused model
    of the same archive: its launches of K1 and K2 a forward (counts 0 just before,
    read just after), the largest logit difference, and the forward ms of both at
    each batch of EXPORT_BATCHES (CUDA events)."""
    from recnext_tpu_torch.export import load_program, load_published

    out = {}
    gen = torch.Generator().manual_seed(6)
    for name, root in model_dirs.items():
        eager = create_model(name, fused=True, device="cuda", dtype=torch.bfloat16)
        eager.load_state_dict(load_published(name, root), strict=True)
        rec = {}
        for batch in EXPORT_BATCHES:
            program = load_program(str(Path(root) / f"{name}_b{batch}.pt2"))
            x = torch.randn(batch, 3, 224, 224, generator=gen).to(torch.bfloat16).cuda()
            with torch.inference_mode():
                want = eager(x).float()
                for fn in COUNTERS.values():  # the exported program's forward starts here
                    fn.launches = 0
                got = program(x).float()
                torch.cuda.synchronize()
                launches = {k: v for k, v in counts().items() if v}  # ... and ends here
                iters = 20 if batch == 8 else 5
                rec[f"batch_{batch}"] = {
                    "launches_per_forward": launches,
                    "max_abs_diff_vs_eager": (got - want).abs().max().item(),
                    "max_abs_logit": want.abs().max().item(),
                    "program_ms": cuda_ms(lambda: program(x), iters=iters),
                    "eager_ms": cuda_ms(lambda: eager(x), iters=iters)}
        out[name] = rec
    return out


def phase_export(work_dir: Path, pool):
    """The export CLI (``python -m recnext_tpu_torch.export``) on m1 (the train phase's
    checkpoint, --ema) and a1 (calibrated weights, --torch-ckpt): the published archive
    and a ``torch.export`` program at batch 8; a program at batch 256 by
    ``export_program`` on the same archive. A fresh process loads each and runs it on
    the card (``_export_check``, in a worker of ``pool``, a spawned process that has
    run nothing yet): exactly MIXERS[name] launches of the model's kernel
    and none of the other a forward, logits within the model phase's bf16 tolerance
    (1e-1 max|logit|) of the eager fused model (the same kernels: expect 0)."""
    from recnext_tpu_torch import export as export_cli
    from recnext_tpu_torch.export import export_program, load_published

    dirs, export_s = {}, {}
    # a1's EMA after a few steps is its init, whose eval-mode logits overflow: its
    # weights are the model phase's (BN statistics of a random batch)
    torch.save(calibrated("recnext_a1").state_dict(), work_dir / "a1_calibrated.pth")
    sources = {"recnext_m1": ["--ckpt", str(work_dir / "m1_224.pt"), "--ema"],
               "recnext_a1": ["--torch-ckpt", str(work_dir / "a1_calibrated.pth")]}
    for name, source in sources.items():
        root = work_dir / f"export_{name}"
        t0 = time.perf_counter()
        _run_cli(export_cli.main, ["--model", name, *source, "--out", str(root), "--batch",
                                   str(EXPORT_BATCHES[0]), "--torch-export"],
                 dict.fromkeys(COUNTERS, 0), f"export {name}")
        for batch in EXPORT_BATCHES[1:]:
            export_program(name, load_published(name, str(root)), batch=batch,
                           out_path=str(root / f"{name}_b{batch}.pt2"))
        export_s[name] = time.perf_counter() - t0
        dirs[name] = str(root)
    torch.cuda.empty_cache()
    checked = pool.apply(_export_check, (dirs,))
    for name, rec in checked.items():
        kernel = "rec_conv2d" if name == "recnext_m1" else "linear_attention"
        for batch, r in rec.items():
            if r["launches_per_forward"] != {kernel: MIXERS[name]}:
                raise AssertionError(f"exported {name} {batch}: launches "
                                     f"{r['launches_per_forward']}, expected "
                                     f"{{{kernel!r}: {MIXERS[name]}}}")
            if not r["max_abs_diff_vs_eager"] <= 1e-1 * r["max_abs_logit"]:
                raise AssertionError(f"exported {name} {batch}: logits differ by "
                                     f"{r['max_abs_diff_vs_eager']}")
    emit({"phase": "export", "dtype": "bf16", "side": 224, "export_s": export_s,
          "route": "custom ops only under torch.compiler.is_exporting(); eager calls "
                   "launch directly", "programs": checked})
    return checked


def phase_train_flags(work_dir: Path):
    """The trainer's remaining flags on the card: m1 (FAKE, 224^2, batch 32, 2 steps an
    epoch) with --ckpt-every-steps 1 and --eval-ema for one epoch; --resume from its
    recovery.pt to epoch 2 with --eval-ema and --export-teacher; then recnext_a1 hard
    distilled from that teacher (--teacher-model recnext_m1 --teacher-ckpt) for 2
    steps. Each run's counts set to 0 just before and read just after: m1 23 K1 and
    23 K1' a step and 23 K1 an eval forward (one a batch under --eval-ema); a1 23 K2
    and 23 K2' a step, 23 K1 a step (the m1 teacher's forward), 23 K2 an eval forward
    (the model and its EMA)."""
    run_dir = work_dir / "flags"
    teacher = work_dir / "m1_teacher.pt"
    zero = dict.fromkeys(COUNTERS, 0)
    m1 = lambda steps, evals: zero | {"rec_conv2d": 23 * (steps + evals),  # noqa: E731
                                      "rec_conv2d_backward": 23 * steps}
    first = _run_cli(train_main.main, FLAGS_ARGS + [
        "--epochs", "1", "--ckpt-every-steps", "1", "--eval-ema", "--output-dir",
        str(run_dir / "a")], m1(FLAGS_STEPS, FLAGS_EVALS), "train_flags: recovery run")
    recovery = run_dir / "a" / "recovery.pt"
    resumed = _run_cli(train_main.main, FLAGS_ARGS + [
        "--epochs", "2", "--resume", str(recovery), "--eval-ema", "--export-teacher",
        str(teacher), "--output-dir", str(run_dir / "b")], m1(FLAGS_STEPS, FLAGS_EVALS),
        "train_flags: resumed run")
    distilled = _run_cli(train_main.main, [
        a if a != "recnext_m1" else "recnext_a1" for a in FLAGS_ARGS] + [
        "--epochs", "1", "--distillation-type", "hard", "--teacher-model", "recnext_m1",
        "--teacher-ckpt", str(teacher), "--output-dir", str(run_dir / "c")],
        zero | {"rec_conv2d": 23 * FLAGS_STEPS,
                "linear_attention": 23 * (FLAGS_STEPS + 2 * FLAGS_EVALS),
                "linear_attention_backward": 23 * FLAGS_STEPS}, "train_flags: distilled a1")
    checks = {"recovery_lines": first["text"].count("recovery checkpoint at"),
              "resumed_at_epoch_1": f"resumed from {recovery} at epoch 1" in resumed["text"],
              "eval_ema_keys_only": all("ema_test_acc1" not in s
                                        for s in first["lines"] + resumed["lines"]),
              "teacher_exported": "exported EMA teacher weights" in resumed["text"],
              "teacher_read": "teacher recnext_m1: " in distilled["text"]}
    if checks["recovery_lines"] != FLAGS_STEPS or not all(list(checks.values())[1:]):
        raise AssertionError(f"train_flags: {checks}")
    if resumed["result"]["state"].step != 2 * FLAGS_STEPS:
        raise AssertionError(f"train_flags: resumed step {resumed['result']['state'].step}")
    losses = [s["train_loss"] for r in (first, resumed, distilled) for s in r["lines"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_flags: losses {losses}")
    emit({"phase": "train_flags", "checks": checks, "train_losses": losses,
          "seconds": {k: r["seconds"] for k, r in (("recovery", first), ("resumed", resumed),
                                                   ("distilled", distilled))},
          "launches": {k: {n: v for n, v in r["launches"].items() if v} for k, r in (
              ("recovery", first), ("resumed", resumed), ("distilled", distilled))}})


def _two_process_step(rank: int, world: int, port: int):
    """m1's train step (bf16 compute, mixup, 224^2) on this rank's rows of a seeded
    global batch of TWO_PROCESS_BATCH: the step-0 loss, K1 and K1' launches a step,
    the step's ms (TWO_PROCESS_TIMED steps after one more, host clock around work that
    ends in a synchronize), and the gradient all-reduce's bytes and ms. world 1 is one
    process on the whole batch, without a process group."""
    from recnext_tpu_torch.parallel.sharding import (all_reduce_gradients, broadcast_tensors,
                                                     init_distributed)
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_train_step

    if world > 1:
        init_distributed(f"127.0.0.1:{port}", world, rank, device_type="cuda",
                         log=lambda m: None)
    try:
        backend = torch.distributed.get_backend() if world > 1 else None
        model = create_model("recnext_m1", device="cuda",
                             generator=torch.Generator().manual_seed(0))
        broadcast_tensors(model.state_dict().values())
        opt = make_optimizer(model.named_parameters(), lambda s: 1e-3)
        state = TrainState.create(model, opt)
        step = make_train_step(num_classes=1000, dtype=torch.bfloat16)
        gen = torch.Generator().manual_seed(7)
        b = TWO_PROCESS_BATCH // world
        x = torch.randn(TWO_PROCESS_BATCH, 3, 224, 224, generator=gen)[rank * b:(rank + 1) * b]
        y = torch.randint(0, 1000, (TWO_PROCESS_BATCH,), generator=gen)[rank * b:(rank + 1) * b]
        batch = {"image": x.cuda(), "label": y.cuda()}
        for fn in COUNTERS.values():
            fn.launches = 0
        loss0 = step(state, batch, torch.Generator().manual_seed(0))["loss"].item()
        launches = {k: v for k, v in counts().items() if v}
        step(state, batch, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        times = []
        for s in range(TWO_PROCESS_TIMED):
            t0 = time.perf_counter()
            step(state, batch, torch.Generator().manual_seed(2 + s))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        reduce_ms, nbytes = [], 0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = all_reduce_gradients(opt.params)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return {"rank": rank, "backend": backend, "step0_loss": loss0,
                "launches_step0": launches, "step_ms": statistics.median(times),
                "allreduce_bytes": nbytes, "allreduce_ms": statistics.median(reduce_ms)}
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def phase_two_process(pool):
    """The m1 train step as 2 processes on the one card (the two workers of ``pool``;
    gloo: NCCL refuses two ranks on one device), against one process at the same
    global batch (in this process):
    each process launches K1 and K1' 23 times a step; the step-0 loss within bf16
    tolerance (1e-2 of it) of one process's; the step's ms (the two processes time-
    slice the card, so slower) and the gradient all-reduce's bytes and ms."""
    import socket

    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ranks = pool.starmap(_two_process_step, [(r, 2, port) for r in range(2)])
    one = _two_process_step(0, 1, 0)
    for r in ranks:
        if r["backend"] != "gloo" or r["launches_step0"] != {"rec_conv2d": 23,
                                                            "rec_conv2d_backward": 23}:
            raise AssertionError(f"two_process rank {r['rank']}: {r}")
        if not abs(r["step0_loss"] - one["step0_loss"]) <= 1e-2 * abs(one["step0_loss"]):
            raise AssertionError(f"two_process: step-0 loss {r['step0_loss']} against one "
                                 f"process's {one['step0_loss']}")
    emit({"phase": "two_process", "model": "recnext_m1", "global_batch": TWO_PROCESS_BATCH,
          "dtype": "bf16 compute, fp32 parameters", "one_process": one, "ranks": ranks,
          "two_over_one_step_ms": max(r["step_ms"] for r in ranks) / one["step_ms"]})
    return ranks, one


# the tools phase: each model's native side, and K1's launches in each section of m1
TOOLS_MODELS = {"recnext_m1": 224, "recnext_a1": 224, "recnext_t": 224, "mlla_mini_recconv": 256}
M1_SECTION_K1 = {"stem": 0, "stage0": 3, "stage1": 3, "stage2": 15, "stage3": 2, "head": 0}


def tools_counts():
    """The roofline rows of the tools phase (``tools/roofline.py``: the work counted on
    the host's CPU, on the plain path, and the H100's bound): each model of
    ``TOOLS_MODELS`` at batch 256 and m1's train step at batch 128. Run in a spawned
    process from the script's start (``main``), beside the kernels' builds."""
    from recnext_tpu_torch.tools import roofline

    torch.set_num_threads(3)  # the other cores build the kernels
    rows = {name: roofline.model_roofline(name, side, batch=256)
            for name, side in TOOLS_MODELS.items()}
    rows["recnext_m1_train_step"] = roofline.train_roofline("recnext_m1", 224, batch=128)
    return rows


def phase_tools(rows, forward_ips, train_ips, train_log: Path, work_dir: Path):
    """The measurement tools (``recnext_tpu_torch/tools/``) on the card: the roofline
    share (``rows``: ``tools_counts``') of each fused forward at batch 256
    (``forward_ips``: the throughput phases' img/s) and of m1's train step at batch
    128 (``train_ips``), each in (0, 100]; m1's
    stage breakdown (0 / 3 / 3 / 15 / 2 K1 launches in the stem and stages 0-3) and
    train-step breakdown (23 K1 and 23 K1′ in the full step); the taps and Winograd
    forms and the taps gradients against cuDNN in f32; the micro-benchmarks at m1's
    shapes; bench_all over m0 and m1 with short windows (no error row), merged, a
    model card from its row; the train phase's log read by analyze_logs."""
    from recnext_tpu_torch.tools import (analyze_logs, bench_all, bwd_micro, merge_results,
                                         micro, modelcard, roofline, stage_breakdown,
                                         train_breakdown)

    rec = {"phase": "tools", "card": nvidia_smi()}
    shares = {name: roofline.with_measured(rows[name], forward_ips[name])
              for name in TOOLS_MODELS}
    shares["recnext_m1_train_step"] = roofline.with_measured(rows["recnext_m1_train_step"],
                                                             train_ips)
    bad = {k: r["roofline_utilization_pct"] for k, r in shares.items()
           if not 0 < r["roofline_utilization_pct"] <= 100}
    if bad:
        raise AssertionError(f"tools: roofline shares outside (0, 100]: {bad}")
    rec["roofline"] = shares
    sections = stage_breakdown.stage_breakdown("recnext_m1", batch=256, iters=10)
    k1 = {s: v["launches"].get("rec_conv2d", 0) for s, v in sections["sections"].items()}
    if k1 != M1_SECTION_K1:
        raise AssertionError(f"tools: stage_breakdown's K1 launches {k1}")
    rec["stage_breakdown"] = sections
    steps = train_breakdown.train_breakdown("recnext_m1", 128, iters=3)
    full = steps["components"]["full"]["launches"]
    if (full["rec_conv2d"], full["rec_conv2d_backward"]) != (23, 23):
        raise AssertionError(f"tools: train_breakdown's full step launched {full}")
    rec["train_breakdown"] = steps
    checks = micro.check_dwconv("cuda") + bwd_micro.check_dw_grads("cuda")
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"tools: taps / Winograd against cuDNN: {checks}")
    rec["dwconv_checks"] = checks
    emit({"phase": "tools_micro", "card": rec["card"]})  # the tools print a line a row
    micro.bench_recconv(256, iters=10)
    micro.bench_dwconv(256, iters=5)
    micro.bench_attention(256, iters=10)
    bwd_micro.bench_dw_bwd(128, iters=3)
    bwd_micro.bench_recconv_bwd(128, iters=3)
    bwd_micro.bench_mlp_bn_bwd(128, iters=3)
    results = work_dir / "bench_all.json"
    rows = bench_all.main(["--models", "recnext_m0", "recnext_m1", "--timed", "1",
                           "--warmup", "1", "--latency", "--stamp", "chip_smoke",
                           "--out", str(results)])
    errors = [r for r in rows if "error" in r]
    if errors:
        raise AssertionError(f"tools: bench_all error rows {errors}")
    merged = merge_results.main([str(results), "--out", str(work_dir / "merged.json"),
                                 "--markdown"])
    card = modelcard.make_card("recnext_m1", measured=merged[1])
    if rec["card"].split(",")[0] not in card or "img/s" not in card:
        raise AssertionError(f"tools: the model card lacks the card or its rate:\n{card}")
    rec["bench_all"] = rows
    times = analyze_logs.train_time(analyze_logs.load_records(str(train_log)))
    if times["records"] < 2 or not times.get("time_mean_s", 0) > 0:
        raise AssertionError(f"tools: analyze_logs over the train phase's log: {times}")
    rec["train_log_times"] = times
    emit(rec)
    return {k: r["roofline_utilization_pct"] for k, r in shares.items()}


# the packed phase: the packed executor (models/packed_infer.py) on fused m1 (K1) and a1
# (K2), bf16, at batch 256 and serving's max_batch 8, at default_groups, g = 2 and g = 4
# at every stage; its sweep's tuples (tools/sweep_packing.py)
PACKED_FORCED = ((2, 2, 2, 2), (4, 4, 4, 4))
PACKED_SWEEP = ((1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 1, 1), (1, 1, 2, 1), (1, 1, 1, 2))


def phase_packed(name, serving):
    """The packed executor on fused ``name`` (``serving``'s bf16 model): in f32 at batch
    256 and 8, g = 2 and 4 at every stage, the logits within atol 2e-4, rtol 2e-5 of the unpacked
    fused model's; in bf16 at batch 256 and 8, at ``default_groups`` and g = 2 and 4,
    each forward no further from the f32 logits than the unpacked bf16 forward plus 1e-2
    max|ref|, and exactly 23 launches of the family's kernel (and none of any other) a
    forward; the packed forward's ms against the unpacked one's at batch 256; one
    request served through ``ServingModel(packed=None)`` with g = 2 at every stage in
    the policy table; tools/sweep_packing.py over ``PACKED_SWEEP`` (a1: and
    tools/attn_breakdown.py at stages 1-2; m1: micro.bench_stage2_packed and
    bench_eval's packed step). Returns the launches of the g = 2 forward at batch 256
    and the sweep's summary."""
    from recnext_tpu_torch.models import packed_infer
    from recnext_tpu_torch.tools import attn_breakdown, bench_eval, micro, sweep_packing

    model = serving.model
    cfg = model.cfg
    gen = torch.Generator().manual_seed(12)
    x256 = torch.randn(256, 3, 224, 224, generator=gen).to("cuda", torch.bfloat16)
    inputs = {256: x256, 8: x256[:8].contiguous()}
    expected = EXPECTED[name]
    out = {"phase": "packed", "model": name, "dtype": "bf16", "card": nvidia_smi(),
           "serving_groups": serving.groups, "forwards": []}
    g2_launches = None
    with torch.inference_mode():
        # f32: the packed executor computes the fused model's function (the 1x1 convs
        # grouped, the rest the same per-plane work): within atol 2e-4, rtol 2e-5, at
        # the main path's batch 256 as at serving's 8
        f32 = create_model(name, fused=True, device="cuda", dtype=torch.float32)
        f32.load_state_dict(model.state_dict(), strict=True)
        exact = {b: f32(x.float()) for b, x in inputs.items()}
        for groups in PACKED_FORCED:
            packed = packed_infer.PackedRecNext(f32, groups)
            for batch, x in inputs.items():
                diff = (packed(x.float()) - exact[batch]).abs()
                bad = diff > 2e-4 + 2e-5 * exact[batch].abs()
                out[f"f32_batch{batch}_g{groups[0]}_max_abs_err"] = diff.max().item()
                if bad.any():
                    raise AssertionError(f"packed f32 {name} {groups} at batch {batch}: "
                                         f"{int(bad.sum())} logits beyond atol 2e-4, "
                                         "rtol 2e-5")
        del f32, packed
        refs = {b: model(x).float() for b, x in inputs.items()}
        for batch, x in inputs.items():
            scale = refs[batch].abs().max().item()
            unpacked_vs_f32 = (refs[batch] - exact[batch]).abs().max().item()
            for groups in (packed_infer.default_groups(cfg, batch), *PACKED_FORCED):
                packed = packed_infer.PackedRecNext(model, groups)
                for fn in COUNTERS.values():  # the packed path starts here
                    fn.launches = 0
                got = packed(x).float()
                torch.cuda.synchronize()
                launches = counts()  # ... and ends here
                err = (got - refs[batch]).abs().max().item()
                row = {"batch": batch, "groups": list(groups), "launches": launches,
                       "max_abs_err_vs_unpacked_bf16": err, "max_abs_ref": scale,
                       "max_abs_err_vs_f32": (got - exact[batch]).abs().max().item(),
                       "unpacked_bf16_max_abs_err_vs_f32": unpacked_vs_f32,
                       "tol_vs_f32": unpacked_vs_f32 + 1e-2 * scale}
                if launches != expected:
                    raise AssertionError(f"packed {name} {groups} at batch {batch}: launches "
                                         f"{launches}, expected {expected}")
                # each bf16 forward is 2.5-3% of max|ref| from the f32 one (its order of
                # summation its own): the packed one may be no further from it than the
                # unpacked one by more than 1e-2 max|ref|
                if got.shape != (batch, 1000) or not torch.isfinite(got).all() or not \
                        row["max_abs_err_vs_f32"] <= unpacked_vs_f32 + 1e-2 * scale:
                    raise AssertionError(f"packed {name} {groups} at batch {batch}: {row}")
                if batch == 256:
                    row["ms"] = cuda_ms(lambda: packed(x), iters=10)
                    if groups == PACKED_FORCED[0]:
                        g2_launches = launches
                out["forwards"].append(row)
                del packed
        out["unpacked_ms_batch_256"] = cuda_ms(lambda: model(x256), iters=10)
    # one request through ServingModel(packed=None), g = 2 at every stage in the table
    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    saved = packed_infer.MEASURED_GROUPS.get(name)
    packed_infer.MEASURED_GROUPS[name] = PACKED_FORCED[0]
    try:
        with tempfile.TemporaryDirectory(dir=build) as archive:
            publish_fused(name, model.state_dict(), archive)
            served = ServingModel(archive, name, max_batch=8)
    finally:
        if saved is None:
            del packed_infer.MEASURED_GROUPS[name]
        else:
            packed_infer.MEASURED_GROUPS[name] = saved
    request = np.random.default_rng(13).normal(size=(1, 3, 224, 224)).astype(np.float32)
    for fn in COUNTERS.values():
        fn.launches = 0
    probs = served.predict(request)
    launches = counts()
    direct = serving.predict(request)
    out["served"] = {"groups": served.groups, "launches": launches,
                     "max_abs_prob_diff_vs_serving_phase": float(np.abs(probs - direct).max())}
    if not served.packed or served.groups != PACKED_FORCED[0] or launches != expected \
            or probs.argmax() != direct.argmax() or not np.abs(probs - direct).max() <= 1e-2:
        raise AssertionError(f"packed serving of {name}: {out['served']}")
    del served
    # the tools
    sweep = sweep_packing.sweep(name, PACKED_SWEEP, batch=256, iters=10)
    out["sweep"] = sweep
    if name == "recnext_a1":
        out["attn_breakdown"] = [
            attn_breakdown.breakdown_stage(name, stage, 256, groups, iters=20)
            for groups in (None, PACKED_FORCED[0]) for stage in (1, 2)]
        per_block = [r["k2_launches_per_block"] for r in out["attn_breakdown"]]
        if per_block != [1] * len(per_block):
            raise AssertionError(f"attn_breakdown: K2 launches a block {per_block}")
    else:
        out["stage2_packed"] = micro.bench_stage2_packed(256, iters=10)
        out["bench_eval"] = bench_eval.bench_eval(name, 256, iters=3, groups=PACKED_FORCED[0])
    emit(out)
    return g2_launches, sweep["summary"]


def run_tasks():
    """The downstream tasks' phases; returns the tasks_path line and each phase's
    seconds. Run in a process of its own (``tasks_process``)."""
    seconds = {}

    def timed(name, fn, *args, tf32=False, **kwargs):
        """``fn`` with cuDNN's TF32 ``tf32``: on (PyTorch's default) where the task CLIs
        and their steps run as a user runs them, off where a kernel is held against
        its plain version in full fp32."""
        t = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = tf32
        result = fn(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return result

    work_dir = Path(tempfile.mkdtemp(dir=Path(__file__).resolve().parent / "recnext_tpu_torch"
                                     / "_build"))
    try:
        m3 = classifier_checkpoint("recnext_m3", work_dir / "recnext_m3.pt")
        seg_step, seg = timed("tasks_seg", phase_tasks_seg, work_dir, m3, tf32=True)
        timed("tasks_seg", phase_tasks_grad, m3)
        recconv = timed("tasks_seg", phase_tasks_recconv)
        level = timed("tasks_seg", phase_tasks_level_backward)
        det_step, det = timed("tasks_det", phase_tasks_det, work_dir, m3, tf32=True)
        mrcnn_step, mrcnn = timed("tasks_mask_rcnn", phase_tasks_mask_rcnn, work_dir, m3,
                                  tf32=True)
        mrcnn_grad = timed("tasks_mask_rcnn", phase_tasks_mask_rcnn_grad, m3)
        a3 = classifier_checkpoint("recnext_a3", work_dir / "recnext_a3.pt")
        a3_grad = timed("tasks_a", phase_tasks_grad, a3, "recnext_a3")
        attention, attention_err = timed("tasks_a", phase_tasks_attention)
    finally:
        shutil.rmtree(work_dir)
    return {"seg_launches_per_step": {k: v for k, v in seg_step.items() if v},
            "det_launches_per_step": {k: v for k, v in det_step.items() if v},
            "seg_step": {k: seg[k] for k in ("step_ms", "images_per_s", "device_idle_share",
                                             "peak_memory_gib")},
            "det_step": {k: det[k] for k in ("step_ms", "images_per_s", "device_idle_share",
                                             "peak_memory_gib")},
            "mask_rcnn_launches_per_step": {k: v for k, v in mrcnn_step.items() if v},
            "mask_rcnn_step": {k: mrcnn["step"][k] for k in (
                "step_ms", "images_per_s", "device_idle_share", "peak_memory_gib",
                "port_kernels_ms", "port_kernels_share_of_step")},
            "mask_rcnn_stages": mrcnn["stages"],
            "mask_rcnn_predict": {k: mrcnn[k] for k in (
                "predict_ms_per_batch", "forward_ms_per_batch",
                "postprocess_and_paste_ms_per_image")},
            "mask_rcnn_grad": {k: mrcnn_grad[k] for k in (
                "backward_worst_err_over_max_ref", "gradients_worst_err_over_max_exact")},
            "k1_k1bwd_totals": recconv, "level_backward_step_totals": level,
            "a3_grad": {k: a3_grad[k] for k in ("backward_worst_err_over_max_ref",
                                                 "gradients_worst_err_over_max_exact")},
            "a3_attention_totals": attention, "a3_bf16_max_abs_err": attention_err}, seconds


def tasks_process():
    """``run_tasks`` in a fresh process (spawned, as ``mlla_process``)."""
    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(run_tasks)


def forward_totals(per_shape, table):
    """Sums over one forward's launches (launch counts from ``table``)."""
    total = {key: sum(table[s][2] * per_shape[s][key] for s in table)
             for key in ("kernel_ms", "plain_ms", "kernel_call_ms", "plain_call_ms",
                         "bytes", "flops")}
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["flops"])
    return total


def kernel_record(name, source, replaces, launches, max_abs_err, total):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": total["kernel_ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": total["bound_by"], "library_ms": total.get("library_ms")}


def run_mlla():
    """The MLLA phases; returns the mlla_path line's launch counts and kernel totals,
    and each phase's seconds. Run in a process of its own (``mlla_process``)."""
    torch.backends.cudnn.allow_tf32 = False  # f32 references in full fp32
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return result

    totals, errs = timed("mlla_kernels", phase_mlla_kernels)
    launches = {v: timed("mlla_model", phase_mlla_model, v) for v in MLLA_KERNELS}
    ips = {}
    for variant, kernel in (("recconv", "rec_conv2d"), ("recattn_simple", "linear_attention")):
        ips[variant] = {"forward": timed("mlla_throughput", phase_mlla_throughput, variant,
                                         totals[kernel]["kernel_ms"]),
                        "train": timed("mlla_train", phase_mlla_train_throughput, variant)}
    trainer = timed("mlla_train", phase_mlla_train)
    return {"launches_forward_and_step": launches, "trainer_launches": trainer,
            "kernel_totals": totals, "bf16_max_abs_err": errs,
            "images_per_s": {v: {"forward_batch_256": r["forward"]["images_per_s"],
                                 "train_batch_128": r["train"]["images_per_s_median"]}
                             for v, r in ips.items()}}, seconds


def mlla_process():
    """``run_mlla`` in a fresh process (spawned; the kernels' libraries load from the
    build the parent made): in a process that had already traced many profiler
    sessions, the profiler saw no device time at all (my chip runs, PR 14), so the
    MLLA phases' traces run in a process of their own. The pool ends with the call."""
    torch.cuda.empty_cache()  # the parent's cached blocks back to the card
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(run_mlla)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    card = nvidia_smi()
    start = t0 = time.perf_counter()
    # the tools phase's counts on the host's CPU, beside the builds (a spawned process)
    counts_pool = multiprocessing.get_context("spawn").Pool(1)
    tools_rows = counts_pool.apply_async(tools_counts)
    counts_pool.close()
    libraries = (recconv_cuda.LIBRARY, attention_cuda.LIBRARY, recconv_bwd_cuda.LIBRARY,
                 attention_bwd_cuda.LIBRARY, level_bwd_cuda.LIBRARY)
    build_pool = ThreadPoolExecutor(len(libraries))  # one nvcc per source, together
    builds = [build_pool.submit(lib.load) for lib in libraries]
    for build in builds[:-1]:
        build.result()
    torch.backends.cudnn.allow_tf32 = False  # f32 references in full fp32

    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return result

    # while the peeled level's library (the longest nvcc) builds: the checks that time
    # nothing on the host and need no peeled level. m1's K1, a1's and the L family's
    # K2 and fused models, the backward kernels at m1's, a1's and recnext_t's shapes
    # and the full-size gradients
    per_shape, k1_err = timed("kernel", phase_kernel)
    per_stage, k2_err = timed("attention", phase_attention)
    a1_unfused, _ = timed("model", phase_model, "recnext_a1")
    l_totals, _ = timed("attention_l", phase_attention_l)
    l_launches = {}
    for name in L_MODELS[1:]:
        _, l_launches[name] = timed("model_l", phase_model, name)
    t_unfused, l_launches["recnext_t"] = timed("model_l", phase_model, "recnext_t")
    bwd_total, bwd_err = timed("backward", phase_backward)
    timed("train_grad", phase_train_grad)
    abwd_total, abwd_err = timed("attention_backward", phase_attention_backward)
    timed("train_grad", phase_train_grad, "recnext_a1")
    t_bwd_total, _ = timed("attention_backward_l", phase_attention_backward_l)
    timed("train_grad_l", phase_train_grad, "recnext_t")
    builds[-1].result()
    build_pool.shutdown()
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "kernel_build_s": {lib.name: lib.build_seconds for lib in libraries},
          "kernel_load_s": time.perf_counter() - t0,
          "cudnn_allow_tf32": False})

    # recnext_m1: kernel K1 (its level kernel for planes too large for it)
    m1_total = forward_totals(per_shape, M1_MIXERS)
    level_total, level_err = timed("large_plane", phase_large_planes)
    _, m1_640 = timed("model", phase_model, "recnext_m1", side=640, batch=2,
                      peeled=3, level_launches=M1_640_LEVEL_LAUNCHES)  # stage 0 peels
    timed("model", phase_model, "recnext_m1", recconv_mode="nearest")
    unfused, _ = timed("model", phase_model, "recnext_m1")
    serving, m1_launches = timed("serving", phase_serving, "recnext_m1", unfused)
    ips = {"recnext_m1": timed("throughput", phase_throughput, "recnext_m1", serving.model,
                               "recconv_kernel", m1_total["kernel_ms"])}
    # the packed executor on m1 (K1)
    m1_packed, m1_sweep = timed("packed", phase_packed, "recnext_m1", serving)
    del unfused, serving

    # recnext_a1: kernel K2
    a1_total = forward_totals(per_stage, A1_ATTENTION)
    serving, a1_launches = timed("serving", phase_serving, "recnext_a1", a1_unfused)
    ips["recnext_a1"] = timed("throughput", phase_throughput, "recnext_a1", serving.model,
                              "linear_attention_kernel", a1_total["kernel_ms"])
    # the packed executor on a1 (K2)
    a1_packed, a1_sweep = timed("packed", phase_packed, "recnext_a1", serving)
    del a1_unfused, serving

    # the L family (recnext_t, recnext_b, recnext_t_share_channel): K2 at one head per
    # image, LA3's v a channel slice; RepVGGDW fused; no RecConv2d
    serving, t_served = timed("serving_l", phase_serving, "recnext_t", t_unfused)
    ips["recnext_t"] = timed("throughput_l", phase_throughput, "recnext_t", serving.model,
                             "linear_attention_kernel", l_totals["recnext_t"]["kernel_ms"])
    del t_unfused, serving

    # recnext_m1 training: K1 and the backward kernel
    work_dir = Path(tempfile.mkdtemp(dir=Path(__file__).resolve().parent / "recnext_tpu_torch"
                                     / "_build"))
    train_launches = timed("train", phase_train, keep=work_dir / "m1_224.pt")
    m1_step = timed("train_throughput", phase_train_throughput)

    # recnext_a1 training with the reference recipe's distillation: K2 and K2'
    a1_train_launches = timed("train", phase_train, "recnext_a1", A1_TRAIN_ARGS)
    plain_ips, _ = timed("train_throughput", phase_train_throughput, "recnext_a1")
    distilled_ips, _ = timed("train_throughput", phase_train_throughput, "recnext_a1", TEACHER)
    emit({"phase": "distillation_cost", "model": "recnext_a1", "teacher": TEACHER,
          "images_per_s": {"plain": plain_ips, "hard_distilled": distilled_ips},
          "step_ms": {"plain": 128e3 / plain_ips, "hard_distilled": 128e3 / distilled_ips},
          "distilled_over_plain": plain_ips / distilled_ips})
    # the export CLI, the trainer's remaining flags, two processes on the one card
    # two spawned workers, started here so that their start-up overlaps the exports:
    # the export check runs in one, then the two processes of the m1 step in both
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        timed("export", phase_export, work_dir, pool)
        timed("train_flags", phase_train_flags, work_dir)
        timed("two_process", phase_two_process, pool)
    # recnext_t training: K2 and K2' at the L shapes
    t_train_launches = timed("train_l", phase_train, "recnext_t", T_TRAIN_ARGS)
    timed("train_throughput_l", phase_train_throughput, "recnext_t")
    # recnext_m1 training beyond the main paths: K1′'s peeled route, the 384^2 finetune
    level_totals, level_errs = timed("large_plane_backward", phase_large_plane_backward)
    m1_512 = timed("train_grad", phase_train_grad, side=512, batch=2, expected=M1_512_TRAIN,
                   peeled=3)
    timed("finetune", phase_finetune, work_dir / "m1_224.pt", work_dir)
    # the data pipeline: m1 trained from a folder of JPEGs
    timed("input_pipeline", phase_input_pipeline, work_dir, *m1_step)
    # the MLLA graft family (mlla_mini at 256^2): K1 and K1' (recconv, nearest), K2 and
    # K2' (recattn_simple), the RoPE attention in plain PyTorch (recattn)
    mlla, mlla_seconds = timed("mlla", mlla_process)
    seconds.update(mlla_seconds)
    # the downstream tasks: recnext_m3 Semantic FPN and RetinaNet (K1, K1', KL'1-3 at
    # batch 16, fp32), recnext_a3 Semantic FPN (K2, K2')
    tasks, tasks_seconds = timed("tasks", tasks_process)
    seconds.update(tasks_seconds)
    # the measurement tools, against the rates the throughput phases measured
    ips["mlla_mini_recconv"] = mlla["images_per_s"]["recconv"]["forward_batch_256"]
    rows = tools_rows.get()
    counts_pool.join()
    shares = timed("tools", phase_tools, rows, ips, m1_step[0], work_dir / "m1_224.log",
                   work_dir)
    shutil.rmtree(work_dir)
    emit({"phase": "seconds", **seconds, "script": time.perf_counter() - start})
    # the L path's launches and K2 / K2' totals (the kernel record below is a1's)
    emit({"phase": "l_path", "k2_launches_per_forward": l_launches,
          "k2_launches_served_recnext_t": t_served, "recnext_t_train": t_train_launches,
          "k2_forward_totals": l_totals, "k2_backward_step_total_recnext_t": t_bwd_total})
    emit({"phase": "mlla_path", **mlla})
    emit({"phase": "tasks_path", **tasks})
    emit({"phase": "tools_path", "roofline_utilization_pct": shares})
    emit({"phase": "packed_path", "launches_g2_batch_256": {"recnext_m1": m1_packed,
                                                             "recnext_a1": a1_packed},
          "sweep": {"recnext_m1": m1_sweep, "recnext_a1": a1_sweep}})

    emit({"kernels": [
        kernel_record("rec_conv2d", "recnext_tpu_torch/csrc/recconv.cu",
                      "recnext_tpu/ops/pallas/recconv.py:135",
                      m1_launches["rec_conv2d"], k1_err, m1_total),
        kernel_record("rec_conv2d_level", "recnext_tpu_torch/csrc/recconv_level_bwd.cu",
                      "recnext_tpu/ops/pallas/recconv.py:135",
                      m1_640["rec_conv2d_level"], level_err, level_total),
        kernel_record("linear_attention", "recnext_tpu_torch/csrc/linear_attention.cu",
                      "recnext_tpu/ops/pallas/linear_attention.py:53",
                      a1_launches["linear_attention"], k2_err, a1_total),
        kernel_record("rec_conv2d_backward", "recnext_tpu_torch/csrc/recconv_bwd.cu",
                      "gradient of recnext_tpu/ops/recconv.py:rec_conv2d; no Pallas backward",
                      train_launches["rec_conv2d_backward"], bwd_err, bwd_total),
        kernel_record("linear_attention_backward",
                      "recnext_tpu_torch/csrc/linear_attention_bwd.cu",
                      "gradient of recnext_tpu/ops/attention.py:linear_attention_kv_first; "
                      "no Pallas backward",
                      a1_train_launches["linear_attention_backward"], abwd_err, abwd_total),
        *(kernel_record(kernel, "recnext_tpu_torch/csrc/recconv_level_bwd.cu",
                        "gradient of recnext_tpu/ops/recconv.py:rec_conv2d (a peeled level); "
                        "no Pallas backward", m1_512[kernel], level_errs[kernel],
                        level_totals[kernel]) for kernel in LEVEL_BWD)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
