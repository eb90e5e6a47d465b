#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (recnext_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then:

1. env        card name and power limit, torch/CUDA versions, kernel build time;
2. kernel     the RecConv2d kernel against its plain PyTorch version at recnext_m1's
              four mixer shapes (224^2), an odd 15^2 plane and a 96^2 plane, in f32
              (cuDNN TF32 off; tolerance 2e-5 max|ref|) and in bf16 (against the
              plain version in f32 on the same bf16 values; tolerance 1e-2 max|ref|,
              bf16 keeps 8 bits); times kernel and plain version at batch 256 bf16;
3. model      recnext_m1 from a seeded generator, BN statistics calibrated on a
              random batch, fused with fuse_params; the fused model's logits through
              the kernel against the plain path (f32 and bf16), and exactly 23
              kernel launches per forward;
4. serving    publish_fused -> ServingModel(max_batch=8) -> HTTP server: /ping,
              /models/recnext_m1, then >= 16 requests from several threads through
              the micro-batcher (the path a POST takes after decoding), each equal
              to a direct predict; the main path whose kernel launches are counted;
5. throughput fused bf16 m1 at batch 256 and batch 1, timed with CUDA events, through
              the kernel and (for scale) with the mixers on the plain version.

Every phase prints one JSON line. Any failure raises and the exit code is not 0.
In the kernel record, "launches" counts the serving phase's launches; "ms",
"plain_ms" and "bound_ms" are the sums over the 23 launches of one m1 forward at
batch 256 in bf16.
The last lines are the kernel record, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from recnext_tpu_torch.export import publish_fused
from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.ops.cuda import recconv as recconv_cuda
from recnext_tpu_torch.ops.recconv import rec_conv2d, rec_conv2d_fused
from recnext_tpu_torch.serve import ServingModel, make_server

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside
# the tensor cores, which is what the kernel's arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
M1_MIXERS = {  # level -> (channels, plane side, launches per m1 forward) at 224^2
    4: (48, 56, 3), 3: (96, 28, 3), 2: (192, 14, 15), 1: (384, 7, 2)}


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


def phase_kernel():
    gen = torch.Generator().manual_seed(0)

    def inputs(n, c, s, level, dtype):
        x = torch.randn(n, c, s, s, generator=gen)
        ws = [torch.randn(c, 1, 5, 5, generator=gen) / 5 for _ in range(level + 2)]
        return x.to("cuda", dtype), [t.to("cuda", dtype) for t in ws]

    cases = [(64, c, s, level) for level, (c, s, _) in M1_MIXERS.items()]
    cases += [(64, 32, 15, 2), (8, 48, 96, 4)]
    per_shape = {}
    max_abs_err = 0.0
    for n, c, s, level in cases:
        x, ws = inputs(n, c, s, level, torch.float32)
        want = rec_conv2d(x, ws[0], ws[1:], level=level)
        got = rec_conv2d_fused(x, ws[0], ws[1:], level=level)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err32 = (got - want).abs().max().item()
        if not err32 <= 2e-5 * scale:
            raise AssertionError(f"f32 kernel mismatch at {(n, c, s, level)}: "
                                 f"{err32} > 2e-5 * {scale}")
        xb, wsb = x.bfloat16(), [t.bfloat16() for t in ws]
        got16 = rec_conv2d_fused(xb, wsb[0], wsb[1:], level=level).float()
        want16 = rec_conv2d(xb.float(), wsb[0].float(), [t.float() for t in wsb[1:]],
                            level=level)
        scale16 = want16.abs().max().item()
        err16 = (got16 - want16).abs().max().item()
        if not err16 <= 1e-2 * scale16:
            raise AssertionError(f"bf16 kernel mismatch at {(n, c, s, level)}: "
                                 f"{err16} > 1e-2 * {scale16}")
        rec = {"phase": "kernel", "shape": [n, c, s, s], "level": level,
               "f32_max_abs_err": err32, "f32_max_abs_ref": scale,
               "bf16_max_abs_err": err16, "bf16_max_abs_ref": scale16}
        if level in M1_MIXERS and (c, s) == M1_MIXERS[level][:2]:
            max_abs_err = max(max_abs_err, err16)
            # timing at the main path's size: batch 256, bf16
            xt, wst = inputs(256, c, s, level, torch.bfloat16)
            kms = cuda_ms(lambda: rec_conv2d_fused(xt, wst[0], wst[1:], level=level))
            pms = cuda_ms(lambda: rec_conv2d(xt, wst[0], wst[1:], level=level), iters=5)
            nbytes, flops = recconv_work(256, c, s, s, level, 5, 2)
            bms, by = bound(nbytes, flops)
            per_shape[level] = dict(kernel_ms=kms, plain_ms=pms, bytes=nbytes, flops=flops)
            rec.update(batch_256_bf16={"kernel_ms": kms, "plain_ms": pms, "bound_ms": bms,
                                       "bound_by": by, "bytes": nbytes, "flops": flops})
        emit(rec)
    return per_shape, max_abs_err


def calibrated_m1():
    """recnext_m1 with seeded weights and non-trivial BN: affine drawn from the
    generator, running statistics those of one random batch."""
    gen = torch.Generator().manual_seed(1)
    model = create_model("recnext_m1", device="cuda", generator=gen)
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
    """Route every RecConv2d mixer through its plain version (until restored)."""
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    for m in mixers:
        m.forward = m.forward_plain
    return lambda: [m.__dict__.pop("forward") for m in mixers]


def phase_model():
    unfused = calibrated_m1()
    fused_sd = fuse_params(unfused.state_dict())
    x = torch.randn(8, 3, 224, 224, generator=torch.Generator().manual_seed(2)).cuda()
    out = {"phase": "model", "model": "recnext_m1", "input": [8, 3, 224, 224]}
    with torch.inference_mode():
        restore = plain_path(unfused)
        ref = unfused(x).float()  # unfused f32, plain path: the reference
        restore()
        for name, dtype, tol_ref, tol_plain in (
                ("f32", torch.float32, 1e-3, 1e-4),
                # bf16 keeps 8 bits: ~100 layers each rounding at 2^-9 drift by a
                # few percent of the logits' scale, and the max over 8k logits more
                ("bf16", torch.bfloat16, 1e-1, 1e-1)):
            model = create_model("recnext_m1", fused=True, device="cuda", dtype=dtype)
            model.load_state_dict(fused_sd, strict=True)
            xin = x.to(dtype)
            before = rec_conv2d_fused.launches
            got = model(xin).float()
            torch.cuda.synchronize()
            launches = rec_conv2d_fused.launches - before
            if launches != 23:
                raise AssertionError(f"{name}: {launches} kernel launches per m1 forward, "
                                     "expected 23")
            restore = plain_path(model)
            plain = model(xin).float()
            restore()
            if got.shape != (8, 1000) or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: bad logits {tuple(got.shape)}")
            scale = ref.abs().max().item()
            e_ref = (got - ref).abs().max().item()
            e_plain = (got - plain).abs().max().item()
            top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            out[name] = {"launches_per_forward": launches, "max_abs_err_vs_unfused_f32":
                         e_ref, "max_abs_err_vs_plain_path": e_plain,
                         "max_abs_logit": scale, "top1_agree_vs_unfused_f32": top1,
                         "tol_vs_unfused_f32": tol_ref * scale,
                         "tol_vs_plain_path": tol_plain * scale}
            if not (e_ref <= tol_ref * scale and e_plain <= tol_plain * scale):
                raise AssertionError(f"{name} logits disagree: {out[name]}")
    emit(out)
    return unfused


def phase_serving(unfused):
    build = Path(__file__).resolve().parent / "recnext_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as archive:
        publish_fused("recnext_m1", unfused.state_dict(), archive)
        serving = ServingModel(archive, "recnext_m1", max_batch=8)
    serving.warmup()
    srv = make_server(serving, port=0, window_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/ping", timeout=30) as r:
            ping = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/models/recnext_m1", timeout=30) as r:
            info = json.loads(r.read())
        if ping != {"status": "Healthy"} or info["model"] != "recnext_m1":
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
        rec_conv2d_fused.launches = 0  # the main path starts here
        clients = [threading.Thread(target=client, args=(range(j, 24, 6),))
                   for j in range(6)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        launches = rec_conv2d_fused.launches  # ... and ends here
        batches = serving.batches_run - batches0
        if errors or len(results) != 24 or any(t.is_alive() for t in clients):
            raise AssertionError(f"serving failed: {len(results)}/24 answered, {errors[:3]}")
        if launches != 23 * batches:
            raise AssertionError(f"{launches} kernel launches for {batches} batches")
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
    emit({"phase": "serving", "requests_served": len(results), "batches_run": batches,
          "kernel_launches": launches, "p50_latency_ms": 1e3 * statistics.median(lat),
          "max_latency_ms": 1e3 * lat[-1], "max_abs_prob_diff_vs_predict": worst,
          "model_info": info})
    return serving, launches


def phase_throughput(model):
    """Fused m1 at batch 256 and batch 1: the kernel path, then (for scale only)
    the same model with its mixers on the plain version."""
    gen = torch.Generator().manual_seed(4)
    dtype = next(model.parameters()).dtype
    x256 = torch.randn(256, 3, 224, 224, generator=gen).to("cuda", dtype)
    x1 = x256[:1].contiguous()
    out = {"phase": "throughput", "model": "recnext_m1", "dtype": str(dtype), "fused": True}
    with torch.inference_mode():
        for path in ("kernel_path", "plain_path"):
            restore = plain_path(model) if path == "plain_path" else None
            ms256 = cuda_ms(lambda: model(x256), iters=10, warmup=3)
            ms1 = cuda_ms(lambda: model(x1), iters=50, warmup=5)
            if restore:
                restore()
            out[path] = {"batch_256_ms": ms256, "images_per_s": 256 * 1e3 / ms256,
                         "batch_1_latency_ms": ms1}
    emit(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    card = nvidia_smi()
    t0 = time.perf_counter()
    recconv_cuda.load_library()
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "kernel_build_s": recconv_cuda.build_seconds,
          "kernel_load_s": time.perf_counter() - t0,
          "cudnn_allow_tf32": False})
    torch.backends.cudnn.allow_tf32 = False  # f32 references in full fp32

    per_shape, max_abs_err = phase_kernel()
    unfused = phase_model()
    serving, launches = phase_serving(unfused)
    phase_throughput(serving.model)

    # one m1 forward at batch 256 runs the kernel 3+3+15+2 times at these shapes
    total = {key: sum(M1_MIXERS[lv][2] * per_shape[lv][key] for lv in M1_MIXERS)
             for key in ("kernel_ms", "plain_ms", "bytes", "flops")}
    bms, by = bound(total["bytes"], total["flops"])
    emit({"kernels": [{
        "name": "rec_conv2d", "route": "cuda", "source": "recnext_tpu_torch/csrc/recconv.cu",
        "replaces": "recnext_tpu/ops/pallas/recconv.py:135", "launches": launches,
        "max_abs_err": max_abs_err, "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
