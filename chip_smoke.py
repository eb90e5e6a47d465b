#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (recnext_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc per
source, started together), then drives four paths, each with every kernel launch
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
              two launches of the level kernel (csrc/recconv.cu:recconv_level_kernel):
              against the plain version at phase 2's bounds, with the launches and
              peels made; then the level kernel alone at the two shapes of m1's 640^2
              path (the 160^2 down conv and the 80^2 -> 160^2 upsample-add-conv, bf16,
              batch 2) against its plain version, timed as phase 2 does, and its
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
14. train_throughput  bench.train_throughput("recnext_m1", 128) with 3 repeats: the
              median img/s, the spread and the step ms, and a profiler trace of 3
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
   recnext_m1 training beyond the main paths (planes larger than K1′'s shared memory
   through the peeled level's backward kernels, csrc/recconv_level_bwd.cu, and the
   384^2 finetune recipe):
19. large_plane_backward  K1′'s peeled route at 128^2 L4 (C 48, batch 2: a 512^2
              input's stage 0, one level peeled) and 200x334 L4 (C 48, batch 1: COCO's,
              two levels) against its plain version, f32 and bf16, bilinear and
              nearest, at K1′'s bounds, each call's peels (1 and 2) and launches
              (per peeled level: the level kernel and K1 recomputing d and y, KL′1
              and KL′2 twice, KL′3 once; then one K1′ call) asserted, and the same
              bits on three runs in every dtype and mode; then each of the three level kernels (the input
              gradient at stride 1 and 2, the weight gradient at stride 1 with z = x +
              up(y) and at stride 2, the up-step's adjoint) against its plain version
              at the outer level's shapes of both planes, timed with CUDA events
              around queued calls beside its bound, its plain version and one PyTorch
              call of the same function (torch.nn.grad.conv2d_input / conv2d_weight
              with groups=C, aten.upsample_*2d_backward), and its registers;
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
Then each phase's seconds.

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
weight-gradient and 1 adjoint launches at 128^2, batch 2, C 48). The last lines are
the kernel record, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.ops.attention import (
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
# every launch count; each path's serving phase sets them all to 0 before it runs
COUNTERS = {"rec_conv2d": rec_conv2d_fused, "rec_conv2d_level": rec_conv2d_level,
            "linear_attention": linear_attention_fused,
            "rec_conv2d_backward": rec_conv2d_backward,
            "linear_attention_backward": linear_attention_backward,
            "rec_conv2d_level_dgrad": rec_conv2d_level_dgrad,
            "rec_conv2d_level_wgrad": rec_conv2d_level_wgrad,
            "rec_conv2d_up_adjoint": rec_conv2d_up_adjoint}
LEVEL_BWD = ("rec_conv2d_level_dgrad", "rec_conv2d_level_wgrad", "rec_conv2d_up_adjoint")
EXPECTED = {"recnext_m1": dict.fromkeys(COUNTERS, 0) | {"rec_conv2d": 23},
            "recnext_a1": dict.fromkeys(COUNTERS, 0) | {"linear_attention": 23}}
# each training path's kernels: (forward kernel, its backward), 23 calls each a step
TRAIN_KERNELS = {"recnext_m1": ("rec_conv2d", "rec_conv2d_backward"),
                 "recnext_a1": ("linear_attention", "linear_attention_backward")}
# the train phases' runs: FAKE, 224^2, batch 64, 2 epochs of 3 steps; each epoch's eval
# scores 3 batches (capped by --steps-per-epoch) with the model and the EMA. recnext_a1
# trains with the reference recipe's hard distillation from a (seeded) regnety_160
TRAIN_ARGS = ["--model", "recnext_m1", "--data-set", "FAKE", "--simple-aug",
              "--input-size", "224", "--batch-size", "64", "--steps-per-epoch", "3",
              "--log-every", "1", "--seed", "0"]
A1_TRAIN_ARGS = [a if a != "recnext_m1" else "recnext_a1" for a in TRAIN_ARGS] + [
    "--distillation-type", "hard", "--teacher-model", "regnety_160"]
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


def queued_ms(fn, iters: int = 20, ahead: int = 6) -> float:
    """Device ms per call from CUDA events around ``iters`` calls queued behind
    ``ahead`` bf16 8192^2 matmuls (about 1 ms each), so that the host's time per call
    is hidden: the device runs the calls back to back."""
    a = torch.ones(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(ahead):
        a @ a
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
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
    # upsample-add-conv (bf16 160^2 + f32 80^2 -> bf16); batch 2 as in the model phase
    x = torch.randn(2, 48, 160, 160, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(48, 1, 5, 5, generator=gen) / 5).cuda()
    inner = torch.randn(2, 48, 80, 80, generator=gen).cuda()
    total, max_abs_err = {"kernel_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}, 0.0
    for step, stride, up in (("down", 2, None), ("up_add_conv", 1, inner)):
        for mode in ("bilinear", "nearest") if up is not None else ("bilinear",):
            kw = dict(stride=stride, up=up, mode=mode)
            got = rec_conv2d_level(x, w, **kw)
            out_dtype = got.dtype
            got, want = got.float(), rec_conv2d_level_plain(x, w, **kw).float()
            # the plain version in fp32 before its one rounding, as the kernel
            want32 = rec_conv2d_level_plain(x.float(), w, **kw)
            torch.cuda.synchronize()
            scale = want32.abs().max().item()
            err = (got - want32).abs().max().item()
            tol = (2e-5 if out_dtype == torch.float32 else 1e-2) * scale
            if not err <= tol:
                raise AssertionError(f"level kernel {step} {mode} mismatch: {err} > {tol}")
            rec = {"phase": "level_kernel", "step": step, "mode": mode if up is not None else None,
                   "x": [2, 48, 160, 160], "x_dtype": "bf16", "out": list(got.shape),
                   "out_dtype": str(out_dtype).removeprefix("torch."),
                   "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
                   "max_abs_diff_vs_plain_rounded": (got - want).abs().max().item(),
                   "registers": recconv_cuda.level_kernel_attributes(5, stride,
                                                                     torch.bfloat16)}
            if mode == "bilinear":  # the 640^2 model's mode: its time and bound
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
        if ping != {"status": "Healthy"} or info["model"] != name:
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
            ms256 = cuda_ms(lambda: model(x256), iters=10, warmup=3)
            ms1 = cuda_ms(lambda: model(x1), iters=50, warmup=5)
            out[path] = {"batch_256_ms": ms256, "images_per_s": 256 * 1e3 / ms256,
                         "batch_1_latency_ms": ms1}
            if restore:
                restore()
                continue
            for batch, x, ms in ((256, x256, ms256), (1, x1, ms1)):
                kernels = trace(lambda: model(x), iters=5 if batch == 256 else 20)
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
    """``name`` (recnext_m1 or recnext_a1) at full width and depth, ``side``^2,
    ``batch``, f32, in train mode: every parameter's gradient of the loss through the
    kernel path (the forward kernel and its backward in every mixer: K1 and K1', or K2
    and K2'; at 512^2 K1′'s peeled route in stage 0) against the plain path (autograd
    over forward_plain). The counts are set to 0 just before the kernel path and read
    just after: ``expected`` (by default 23 of the forward kernel and of its backward,
    nothing else) and ``peeled`` backward calls that peeled.
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
    expected = expected or dict.fromkeys(COUNTERS, 0) | {fwd: 23, bwd: 23}
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
    ``name`` (recnext_m1; recnext_a1 with hard distillation from a seeded regnety_160),
    FAKE, --simple-aug, 224^2, batch 64, 2 epochs of 3 steps, then a rerun to 3 epochs
    that resumes. Every count set to 0 just before the first run and read just after:
    23 launches of the model's forward kernel (K1 or K2) and 23 calls of its backward
    (K1' or K2') per train step, 23 forward-kernel launches per fused eval forward,
    nothing else (the teacher launches no kernel of the port). The last checkpoint is
    copied to ``keep`` where given."""
    import contextlib
    import io

    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    rec = {"phase": "train", "model": name, "args": args}
    fwd, bwd = TRAIN_KERNELS[name]
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
            per_step = {fwd: (launches[fwd] - 23 * evals) / steps, bwd: launches[bwd] / steps}
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
            if per_step != {fwd: 23, bwd: 23} or any(others.values()):
                raise AssertionError(f"train run to {epochs} epochs: launches {launches}")
            if run["resumed"] != (epochs == 3):
                raise AssertionError(f"train run to {epochs} epochs: resume {run['resumed']}")
        rec["runs"] = runs
        if keep is not None:
            keep.write_bytes((Path(run_dir) / "ckpt" / "epoch_0002.pt").read_bytes())
    emit(rec)
    return runs[0]["launches"]


TRACE_KERNELS = {  # CUDA function names of each training path's kernels: (forward,
    # backward, ...)
    "recnext_m1": ("recconv_kernel", "recconv_bwd_kernel", "recconv_bwd_sum_kernel"),
    "recnext_a1": ("linear_attention_kernel", "linear_attention_bwd_")}  # K2' either route


def phase_train_throughput(name="recnext_m1", teacher=None):
    """bench.train_throughput(name, 128) with 3 repeats (distilled from a seeded
    ``teacher`` where given), then a profiler trace of 3 steps of the same step: the
    top kernels, the backward kernel's share and the device's idle share. The trace
    must list 23 launches a step of each of the port's kernels."""
    ips, batch, spread = bench.train_throughput(name, 128, repeats=3, teacher=teacher)
    step_ms = batch / ips * 1e3
    fn, _ = bench.train_bench_step(name, 128, teacher=teacher)
    kernels = trace(fn, iters=3, warmup=2)
    busy = sum(k["ms"] for k in kernels)
    if busy > step_ms:  # the trace counts some device time twice: no idle share to give
        raise AssertionError(f"train_throughput: device busy {busy} ms in a step of "
                             f"{step_ms} ms")
    # no name of the tuple is a part of another, so a substring picks one kernel
    ours = {kn: sum(k["ms"] for k in kernels if kn in k["name"]) for kn in TRACE_KERNELS[name]}
    launches = {kn: sum(k["launches"] for k in kernels if kn in k["name"])
                for kn in TRACE_KERNELS[name]}
    if any(n != 23 for n in launches.values()):  # each runs once a mixer: 23 a step
        raise AssertionError(f"train_throughput: the trace lists {launches} launches a "
                             f"step of the port's kernels, not 23 each: it lost some, so "
                             f"its busy time and idle share would be wrong")
    emit({"phase": "train_throughput", "model": name, "teacher": teacher,
          "distillation": "hard" if teacher else "none", "batch": batch,
          "dtype": "bf16 compute, fp32 parameters", "images_per_s_median": ips,
          "spread": spread, "step_ms": step_ms, "device_busy_ms_per_step": busy,
          "device_idle_share": 1 - busy / step_ms,
          "kernel_ms_per_step": ours, "kernel_launches_per_step": launches,
          "backward_kernel_share_of_busy": sum(ours[kn] for kn in TRACE_KERNELS[name][1:])
          / busy,
          "top_kernels": kernels[:8]})
    return ips


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

        # the peeled outer level's kernels at this plane, as the bf16 train step runs
        # them: g and x bf16, the recomputed inner plane y, its gradient dd and dz fp32
        dh, dw_ = (h + 1) // 2, (w + 1) // 2
        xb, gb = x.to("cuda", torch.bfloat16), g.to("cuda", torch.bfloat16)
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
        cases = [
            ("rec_conv2d_level_dgrad", "stride 1: dz = conv_L^T(g), bf16 g -> f32", 2e-5,
             lambda: rec_conv2d_level_dgrad(gb, w_l, size=(h, w)),
             lambda: rec_conv2d_level_dgrad_plain(gb, w_l, size=(h, w)),
             lambda: cgrad.conv2d_input((n, c, h, w), w_l, gb.float(), padding=2, groups=c),
             level_bwd_work("dgrad", n, c, h, w, 5, g_bytes=2)),
            ("rec_conv2d_level_dgrad", "stride 2: dx = dz + down^T(dd), f32 -> bf16", 1e-2,
             lambda: rec_conv2d_level_dgrad(dd, w_down, size=(h, w), stride=2, add=dz,
                                            out_dtype=torch.bfloat16),
             lambda: rec_conv2d_level_dgrad_plain(dd, w_down, size=(h, w), stride=2, add=dz),
             lambda: cgrad.conv2d_input((n, c, h, w), w_down, dd, stride=2, padding=2,
                                        groups=c) + dz,
             level_bwd_work("dgrad", n, c, h, w, 5, stride=2, add=True, out_bytes=2)),
            ("rec_conv2d_level_wgrad", "stride 1: dW_L = sum (x + up(y)) * g, bf16", 1e-4,
             lambda: rec_conv2d_level_wgrad(xb, gb, k=5, up=y),
             lambda: rec_conv2d_level_wgrad_plain(xb, gb, k=5, up=y),
             lambda: cgrad.conv2d_weight(z, (c, 1, 5, 5), gb.float(), padding=2, groups=c),
             level_bwd_work("wgrad", n, c, h, w, 5, up=True, in_bytes=2, g_bytes=2)),
            ("rec_conv2d_level_wgrad", "stride 2: dW_down += sum x *_2 dd", 1e-4,
             lambda: rec_conv2d_level_wgrad(xb, dd, k=5, stride=2),
             lambda: rec_conv2d_level_wgrad_plain(xb, dd, k=5, stride=2),
             lambda: cgrad.conv2d_weight(xb.float(), (c, 1, 5, 5), dd, stride=2, padding=2,
                                         groups=c),
             level_bwd_work("wgrad", n, c, h, w, 5, stride=2, in_bytes=2)),
            ("rec_conv2d_up_adjoint", "dy = up^T(dz), bilinear", 2e-5,
             lambda: rec_conv2d_up_adjoint(dz),
             lambda: rec_conv2d_up_adjoint_plain(dz),
             lambda: up_bwd["bilinear"](dz),
             level_bwd_work("up_adjoint", n, c, h, w, 5)),
            ("rec_conv2d_up_adjoint", "dy = up^T(dz), nearest", 2e-5,
             lambda: rec_conv2d_up_adjoint(dz, mode="nearest"),
             lambda: rec_conv2d_up_adjoint_plain(dz, mode="nearest"),
             lambda: up_bwd["nearest"](dz), None)]
        for kernel, what, tol, run, plain, library, work in cases:
            before = COUNTERS[kernel].launches
            got = run()
            if COUNTERS[kernel].launches != before + 1:
                raise AssertionError(f"{kernel} {what}: launches not counted")
            want = plain()
            err, scale = _check_close(f"{kernel} {what} at {[n, c, h, w]}", got, want, tol)
            errs_by_kernel[kernel] = max(errs_by_kernel[kernel], err)
            out = {"phase": "level_backward_kernel", "kernel": kernel, "what": what,
                   "shape": [n, c, h, w], "max_abs_err": err, "max_abs_ref": scale,
                   "tol": tol * scale,
                   "library_max_abs_diff": (library().float() - want.float()).abs().max().item()}
            if work is not None:  # the train step's mode: timed
                times = {"kernel_ms": queued_ms(run), "plain_ms": queued_ms(plain, iters=5),
                         "library_ms": queued_ms(library)}
                bms, by = bound(*work)
                out.update(times, bound_ms=bms, bound_by=by, bytes=work[0], flops=work[1])
                if (n, c, h, w) == LARGE_BWD[0]:  # 3 peeled mixers of m1's 512^2 step
                    tot = step_totals.setdefault(kernel, dict.fromkeys(
                        ("kernel_ms", "plain_ms", "library_ms", "bytes", "flops"), 0.0))
                    for key, val in (*times.items(), ("bytes", work[0]), ("flops", work[1])):
                        tot[key] += 3 * val
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
    ips, batch, spread = bench.train_throughput("recnext_m1", 64, repeats=3, timed_s=3.0, **kw)
    fn, _ = bench.train_bench_step("recnext_m1", 64, **kw)
    kernels = trace(fn, iters=4, warmup=2)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    card = nvidia_smi()
    start = t0 = time.perf_counter()
    libraries = (recconv_cuda.LIBRARY, attention_cuda.LIBRARY, recconv_bwd_cuda.LIBRARY,
                 attention_bwd_cuda.LIBRARY, level_bwd_cuda.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, together
        list(pool.map(lambda lib: lib.load(), libraries))
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "kernel_build_s": {lib.name: lib.build_seconds for lib in libraries},
          "kernel_load_s": time.perf_counter() - t0,
          "cudnn_allow_tf32": False})
    torch.backends.cudnn.allow_tf32 = False  # f32 references in full fp32

    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return result

    # recnext_m1: kernel K1
    per_shape, k1_err = timed("kernel", phase_kernel)
    m1_total = forward_totals(per_shape, M1_MIXERS)
    level_total, level_err = timed("large_plane", phase_large_planes)
    _, m1_640 = timed("model", phase_model, "recnext_m1", side=640, batch=2,
                      peeled=3, level_launches=M1_640_LEVEL_LAUNCHES)  # stage 0 peels
    timed("model", phase_model, "recnext_m1", recconv_mode="nearest")
    unfused, _ = timed("model", phase_model, "recnext_m1")
    serving, m1_launches = timed("serving", phase_serving, "recnext_m1", unfused)
    timed("throughput", phase_throughput, "recnext_m1", serving.model, "recconv_kernel",
          m1_total["kernel_ms"])
    del unfused, serving

    # recnext_a1: kernel K2
    per_stage, k2_err = timed("attention", phase_attention)
    a1_total = forward_totals(per_stage, A1_ATTENTION)
    unfused, _ = timed("model", phase_model, "recnext_a1")
    serving, a1_launches = timed("serving", phase_serving, "recnext_a1", unfused)
    timed("throughput", phase_throughput, "recnext_a1", serving.model,
          "linear_attention_kernel", a1_total["kernel_ms"])
    del unfused, serving

    # recnext_m1 training: K1 and the backward kernel
    work_dir = Path(tempfile.mkdtemp(dir=Path(__file__).resolve().parent / "recnext_tpu_torch"
                                     / "_build"))
    bwd_total, bwd_err = timed("backward", phase_backward)
    timed("train_grad", phase_train_grad)
    train_launches = timed("train", phase_train, keep=work_dir / "m1_224.pt")
    timed("train_throughput", phase_train_throughput)

    # recnext_a1 training with the reference recipe's distillation: K2 and K2'
    abwd_total, abwd_err = timed("attention_backward", phase_attention_backward)
    timed("train_grad", phase_train_grad, "recnext_a1")
    a1_train_launches = timed("train", phase_train, "recnext_a1", A1_TRAIN_ARGS)
    plain_ips = timed("train_throughput", phase_train_throughput, "recnext_a1")
    distilled_ips = timed("train_throughput", phase_train_throughput, "recnext_a1", TEACHER)
    emit({"phase": "distillation_cost", "model": "recnext_a1", "teacher": TEACHER,
          "images_per_s": {"plain": plain_ips, "hard_distilled": distilled_ips},
          "step_ms": {"plain": 128e3 / plain_ips, "hard_distilled": 128e3 / distilled_ips},
          "distilled_over_plain": plain_ips / distilled_ips})
    # recnext_m1 training beyond the main paths: K1′'s peeled route, the 384^2 finetune
    level_totals, level_errs = timed("large_plane_backward", phase_large_plane_backward)
    m1_512 = timed("train_grad", phase_train_grad, side=512, batch=2, expected=M1_512_TRAIN,
                   peeled=3)
    timed("finetune", phase_finetune, work_dir / "m1_224.pt", work_dir)
    shutil.rmtree(work_dir)
    emit({"phase": "seconds", **seconds, "script": time.perf_counter() - start})

    emit({"kernels": [
        kernel_record("rec_conv2d", "recnext_tpu_torch/csrc/recconv.cu",
                      "recnext_tpu/ops/pallas/recconv.py:135",
                      m1_launches["rec_conv2d"], k1_err, m1_total),
        kernel_record("rec_conv2d_level", "recnext_tpu_torch/csrc/recconv.cu",
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
