"""Backward micro-benchmarks on the GPU: for each hot op at recnext_m1's stage shapes,
the forward, the input gradient, the filter gradient and both.

Counterpart of ``recnext_tpu/benchmark/bwd_micro.py``. The loss is the mean of the
output's squares in fp32 (a plain mean would feed the backward a constant
cotangent); a gradient's time includes its forward, as JAX's did. Ops:
``bench_dw_bwd`` (a 5x5 depthwise conv through cuDNN and through the taps form,
whose gradients come from its own decomposition), ``bench_recconv_bwd`` (K1 and K1′,
``RecConv2dFunction``, against autograd over the plain RecConv2d),
``bench_mlp_bn_bwd`` (the block's 1x1 MLP with GELU, and a train-mode BatchNorm);
``check_dw_grads`` holds the taps form's gradients against cuDNN's in f32. Runs on
the GPU unless ``--device cpu``.

  python -m recnext_tpu_torch.tools.bwd_micro --op all --batch 256
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from recnext_tpu_torch.tools.micro import _device, _emit, card, timeit

M1_STAGES = [(56, 48), (28, 96), (14, 192), (7, 384)]
M1_LEVELS = {56: 4, 28: 3, 14: 2, 7: 1}


def time_modes(fn, x, ws, iters: int = 20, device=None) -> dict:
    """ms a call of fwd / dx / dw / both for y = fn(x, ws) (``ws`` a list of weights)."""
    def loss(x, ws):
        return fn(x, ws).float().square().mean()

    def grad(wrt_x, wrt_w):
        xg = x.detach().requires_grad_(wrt_x)
        wg = [w.detach().requires_grad_(wrt_w) for w in ws]
        inputs = ([xg] if wrt_x else []) + (wg if wrt_w else [])
        return lambda: torch.autograd.grad(loss(xg, wg), inputs)

    with torch.no_grad():
        out = {"fwd": timeit(lambda: fn(x, ws), iters=iters, device=device)}
    out["dx"] = timeit(grad(True, False), iters=iters, device=device)
    out["dw"] = timeit(grad(False, True), iters=iters, device=device)
    out["both"] = timeit(grad(True, True), iters=iters, device=device)
    return out


def bench_dw_bwd(batch: int = 256, dtype=torch.bfloat16, kernel: int = 5, stride: int = 1,
                 device=None, iters: int = 20):
    """A k x k depthwise conv's gradients: cuDNN's (autograd of ``F.conv2d``) against
    the taps form's (``ops/conv.py:depthwise_conv2d_taps``)."""
    from recnext_tpu_torch.ops.conv import depthwise_conv2d_taps

    dev = _device(device)
    pad = kernel // 2
    rows = []
    for h, c in M1_STAGES:
        x = torch.ones(batch, c, h, h, device=dev, dtype=dtype)
        w = [torch.full((c, 1, kernel, kernel), 0.04, device=dev, dtype=dtype)]
        forms = {"conv": lambda x, ws: F.conv2d(x, ws[0], stride=stride, padding=pad,
                                                groups=ws[0].shape[0]),
                 "taps": lambda x, ws: depthwise_conv2d_taps(x, ws[0], stride=stride,
                                                             padding=pad)}
        for name, f in forms.items():
            row = {"op": "dw_bwd", "form": name, "side": h, "channels": c, "stride": stride,
                   "kernel": kernel, "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                   **time_modes(f, x, w, iters, dev)}
            _emit(row, rows)
    return rows


def check_dw_grads(device=None, batch: int = 4):
    """The taps form's input and filter gradients against cuDNN's in f32 (TF32 off) at
    m1's four stage shapes, strides 1 and 2: max|err| / max|ref|, within 2e-5 (input)
    and 1e-4 (filter: a sum over batch and plane)."""
    from recnext_tpu_torch.ops.conv import depthwise_conv2d_taps

    dev = _device(device)
    gen = torch.Generator(dev).manual_seed(2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        for (h, c) in M1_STAGES:
            for stride in (1, 2):
                x = torch.randn(batch, c, h, h, device=dev, generator=gen)
                w = 0.28 * torch.randn(c, 1, 5, 5, device=dev, generator=gen)
                oh = (h + 4 - 5) // stride + 1
                g = torch.randn(batch, c, oh, oh, device=dev, generator=gen)
                grads = []
                for f in (lambda x, w: F.conv2d(x, w, stride=stride, padding=2, groups=c),
                          lambda x, w: depthwise_conv2d_taps(x, w, stride=stride, padding=2)):
                    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
                    grads.append(torch.autograd.grad(f(xg, wg), (xg, wg), g))
                (rx, rw), (tx, tw) = grads
                ex = (tx - rx).abs().max().item() / rx.abs().max().item()
                ew = (tw - rw).abs().max().item() / rw.abs().max().item()
                out.append({"side": h, "channels": c, "stride": stride,
                            "dx_err_over_max_ref": ex, "dw_err_over_max_ref": ew,
                            "tol": [2e-5, 1e-4], "ok": ex <= 2e-5 and ew <= 1e-4})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def bench_recconv_bwd(batch: int = 256, dtype=torch.bfloat16, device=None, iters: int = 20):
    """RecConv2d's gradients at m1's four mixer shapes: K1 and K1′ (``rec_conv2d_fused``
    under grad, ``RecConv2dFunction``) against autograd over the plain ``rec_conv2d``."""
    from recnext_tpu_torch.ops.recconv import rec_conv2d, rec_conv2d_fused

    dev = _device(device)
    rows = []
    for h, c in M1_STAGES:
        level = M1_LEVELS[h]
        x = torch.ones(batch, c, h, h, device=dev, dtype=dtype)
        ws = [torch.full((c, 1, 5, 5), 0.04, device=dev, dtype=dtype) for _ in range(level + 2)]
        forms = {"plain": lambda x, ws: rec_conv2d(x, ws[0], ws[1:], level=level)}
        if dev.type == "cuda":
            forms["kernel"] = lambda x, ws: rec_conv2d_fused(x, ws[0], ws[1:], level=level)
        for name, f in forms.items():
            row = {"op": "recconv_bwd", "form": name, "side": h, "channels": c,
                   "level": level, "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                   **time_modes(f, x, ws, iters, dev)}
            _emit(row, rows)
    return rows


def bench_mlp_bn_bwd(batch: int = 256, dtype=torch.bfloat16, device=None, iters: int = 20):
    """The block's MLP (1x1 conv to 2C, GELU, 1x1 conv back) and a train-mode
    BatchNorm in fp32 at m1's stage shapes."""
    dev = _device(device)
    rows = []
    for h, c in M1_STAGES:
        x = torch.ones(batch, c, h, h, device=dev, dtype=dtype)
        mlp_w = [torch.full((2 * c, c, 1, 1), 0.02, device=dev, dtype=dtype),
                 torch.full((c, 2 * c, 1, 1), 0.02, device=dev, dtype=dtype)]
        bn_w = [torch.ones(c, device=dev), torch.zeros(c, device=dev)]

        def mlp(x, ws):
            return F.conv2d(F.gelu(F.conv2d(x, ws[0])), ws[1])

        def bn(x, ws):
            return F.batch_norm(x.float(), None, None, ws[0], ws[1], training=True).to(x.dtype)

        for name, f, ws in (("mlp", mlp, mlp_w), ("bn_train", bn, bn_w)):
            row = {"op": "mlp_bn_bwd", "form": name, "side": h, "channels": c, "batch": batch,
                   "dtype": str(dtype).replace("torch.", ""), **time_modes(f, x, ws, iters, dev)}
            _emit(row, rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--kernel", type=int, default=5)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--op", default="all", choices=["dw", "recconv", "mlpbn", "all"])
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    dev = _device(args.device)
    dtype = getattr(torch, args.dtype)
    print(json.dumps({"device": str(dev), "card": card() if dev.type == "cuda" else "cpu"}),
          flush=True)
    rows = []
    if args.op in ("dw", "all"):
        for r in check_dw_grads(dev):
            _emit({"op": "dw_grad_check", **r}, rows)
        rows += bench_dw_bwd(args.batch, dtype, args.kernel, args.stride, dev)
    if args.op in ("recconv", "all"):
        rows += bench_recconv_bwd(args.batch, dtype, dev)
    if args.op in ("mlpbn", "all"):
        rows += bench_mlp_bn_bwd(args.batch, dtype, dev)
    return rows


if __name__ == "__main__":
    main()
