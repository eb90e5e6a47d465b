"""On the GPU: the layout choices of the MLLA blocks (``models/mlla.py``) at mlla_mini's
shapes, batch 256, bf16, one JSON line a shape.

* LayerNorm over the channels, flax's semantics (fp32 statistics, fp32 scale and
  bias): the port's form (``F.layer_norm`` on an fp32 copy, cast back) against
  PyTorch's mixed-dtype call (bf16 input, fp32 weights), a ``var_mean`` form on the
  channels-last rows and on contiguous NCHW, and (for scale only: it rounds the scale
  and bias) the bf16 call with bf16 weights; forward and forward + backward ms, and
  each one's largest difference from the port's form;
* a downsampling block's cpe1 (5x5, stride 2, two outputs a group) on the
  channels-last stream, on contiguous NCHW, and on an NCHW copy and back; a 5x5
  depthwise conv channels-last against NCHW.

Times are CUDA events around 20 calls after 3 warm-up calls. Then the card's name and
power limit.

  python -m recnext_tpu_torch.tools.mlla_layouts
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

EPS = 1e-6
NORM_SHAPES = ((256, 64, 64, 48), (256, 32, 32, 96), (256, 16, 16, 192), (256, 8, 8, 384),
               (128, 64, 64, 48))
CONV_SHAPES = ((256, 48, 64), (256, 96, 32), (256, 192, 16))


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ln_fp32_copy(x, w, b):  # the port's form (models/layers.py:LayerNorm)
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, EPS).to(x.dtype)


def ln_mixed(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, EPS)


def ln_var_mean_rows(x, w, b):
    xf = x.float()
    var, mu = torch.var_mean(xf, -1, correction=0, keepdim=True)
    return ((xf - mu) * (torch.rsqrt(var + EPS) * w) + b).to(x.dtype)


def ln_var_mean_nchw(x, w, b):  # x contiguous NCHW, normalised over dim 1
    xf = x.float()
    var, mu = torch.var_mean(xf, 1, correction=0, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + EPS) * w[:, None, None]
            + b[:, None, None]).to(x.dtype)


def ln_bf16_weights(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.to(x.dtype), b.to(x.dtype), EPS)


FORMS = {"fp32_copy": ln_fp32_copy, "mixed_dtype": ln_mixed,
         "var_mean_rows": ln_var_mean_rows, "var_mean_nchw": ln_var_mean_nchw,
         "bf16_weights": ln_bf16_weights}


def norm_record(shape, gen) -> dict:
    x = torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    c = shape[-1]
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    b = 0.1 * torch.randn(c, device="cuda", generator=gen)
    ref = ln_fp32_copy(x, w, b).float()
    rec = {"layer_norm_rows": list(shape)}
    for name, fn in FORMS.items():
        nchw = name == "var_mean_nchw"
        arg = x.permute(0, 3, 1, 2).contiguous() if nchw else x
        try:
            y = fn(arg, w, b).float()
        except RuntimeError as e:  # PyTorch refuses the form on this card: say why
            rec[name] = {"error": str(e)[:200]}
            continue
        y = y.permute(0, 2, 3, 1) if nchw else y
        xg, wg, bg = (t.detach().requires_grad_() for t in (arg, w, b))
        gy = torch.randn(y.shape, device="cuda", generator=gen).to(arg.dtype)
        gy = gy.permute(0, 3, 1, 2).contiguous() if nchw else gy
        rec[name] = {
            "fwd_ms": cuda_ms(lambda: fn(arg, w, b)),
            "fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(fn(xg, wg, bg), (xg, wg, bg), gy),
                                  iters=10),
            "max_abs_diff_vs_fp32_copy": (y - ref).abs().max().item()}
    return rec


def conv_record(shape, gen) -> dict:
    n, c, side = shape
    x = torch.randn(n, c, side, side, device="cuda", generator=gen).bfloat16()
    xcl = x.contiguous(memory_format=torch.channels_last)
    w2 = torch.randn(2 * c, 1, 5, 5, device="cuda", generator=gen).bfloat16()
    w1 = torch.randn(c, 1, 5, 5, device="cuda", generator=gen).bfloat16()
    bias = torch.zeros(2 * c, device="cuda", dtype=torch.bfloat16)
    return {"cpe1_input": [n, c, side, side],
            "strided_channels_last_ms": cuda_ms(lambda: F.conv2d(xcl, w2, bias, 2, 2, 1, c)),
            "strided_nchw_ms": cuda_ms(lambda: F.conv2d(x, w2, bias, 2, 2, 1, c)),
            "strided_nchw_copy_and_back_ms": cuda_ms(lambda: F.conv2d(
                xcl.contiguous(), w2, bias, 2, 2, 1, c).contiguous(
                    memory_format=torch.channels_last)),
            "dw5_channels_last_ms": cuda_ms(lambda: F.conv2d(xcl, w1, None, 1, 2, 1, c)),
            "dw5_nchw_ms": cuda_ms(lambda: F.conv2d(x, w1, None, 1, 2, 1, c))}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mlla_layouts: no CUDA device; this tool runs on the GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in NORM_SHAPES:
        print(json.dumps(norm_record(shape, gen)), flush=True)
    for shape in CONV_SHAPES:
        print(json.dumps(conv_record(shape, gen)), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
