"""The train step's time by component on the GPU: the full step and its pieces, each
timed alone with CUDA events over queued calls.

Counterpart of ``recnext_tpu/benchmark/train_breakdown.py``; the pieces come from
the port's ``train/step.py`` and ``bench.train_bench_step``:

  full       the whole step (mixup, forward, loss, backward, AGC + AdamW, EMA)
  fwd        the train-mode forward and the loss, without gradient
  fwd_bwd    the forward, the loss and the backward (no optimizer, no EMA)
  opt        AGC + AdamW on fixed gradients
  ema        the EMA update (not with ``--no-ema``)
  mixup      mixup/cutmix of the batch
  eval_fwd   the same unfused model's eval-mode forward

Prints one JSON line a component (its ms and its share of ``full``; ``full`` also
carries its kernel launches) and a summary line. Runs on the GPU unless
``--device cpu``.

  python -m recnext_tpu_torch.tools.train_breakdown --model recnext_m1 --batch 128
"""

from __future__ import annotations

import argparse
import json

import torch

from recnext_tpu_torch.tools.micro import _device, card, timeit
from recnext_tpu_torch.tools.stage_breakdown import launches_of


def train_breakdown(model_name: str, batch: int = 128, *, dtype=torch.bfloat16,
                    image_size: int = 224, remat: bool = False, ema: bool = True,
                    device=None, iters: int = 10) -> dict:
    from recnext_tpu_torch.bench import train_bench_step
    from recnext_tpu_torch.data.mixup import mixup_cutmix
    from recnext_tpu_torch.train.state import ema_update
    from recnext_tpu_torch.train.step import forward_model, train_loss

    dev = _device(device)
    full, _ = train_bench_step(model_name, batch, dtype=dtype, image_size=image_size,
                               device=dev, remat=remat, ema=ema)
    state, data = full.state, full.data
    model, opt = state.model, state.optimizer
    x, y = data["image"], data["label"]
    num_classes = model.cfg.num_classes if hasattr(model, "cfg") else 1000
    mix = torch.Generator().manual_seed(0)
    res = {}
    full()  # the first step makes the optimizer's moments
    res["full"] = {"ms": timeit(full, iters=iters, device=dev), "launches": launches_of(full)}

    def fwd():
        model.train()
        with torch.no_grad():
            return train_loss(model, x, y, dtype=dtype, remat=remat)

    def fwd_bwd():
        model.train()
        opt.zero_grad()
        train_loss(model, x, y, dtype=dtype, remat=remat).backward()

    res["fwd"] = {"ms": timeit(fwd, iters=iters, device=dev)}
    res["fwd_bwd"] = {"ms": timeit(fwd_bwd, iters=iters, device=dev)}
    with torch.no_grad():
        for p in opt.params:
            p.grad = torch.full_like(p, 1e-4)
    res["opt"] = {"ms": timeit(opt.step, iters=iters, device=dev)}
    if state.ema is not None:
        res["ema"] = {"ms": timeit(lambda: ema_update(state.ema, model, 0.99996), iters=iters,
                                   device=dev)}
    res["mixup"] = {"ms": timeit(lambda: mixup_cutmix(mix, x, y, num_classes=num_classes),
                                 iters=iters, device=dev)}

    def eval_fwd():
        model.eval()
        with torch.no_grad():
            return forward_model(model, x, dtype)

    res["eval_fwd"] = {"ms": timeit(eval_fwd, iters=iters, device=dev)}
    model.train()
    full_ms = res["full"]["ms"]
    for v in res.values():
        v["pct_of_full"] = 100 * v["ms"] / full_ms
    accounted = sum(res[k]["ms"] for k in ("fwd_bwd", "opt", "ema", "mixup") if k in res)
    summary = {"model": model_name, "batch": batch, "image_size": image_size, "remat": remat,
               "ema": ema, "dtype": str(dtype).replace("torch.", ""), "device": str(dev),
               "train_img_per_s": batch / full_ms * 1e3,
               "bwd_minus_fwd_ms": res["fwd_bwd"]["ms"] - res["fwd"]["ms"],
               "accounted_ms": accounted, "unaccounted_ms": full_ms - accounted,
               "train_over_eval_fwd": full_ms / res["eval_fwd"]["ms"]}
    return {"components": res, "summary": summary}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    dev = _device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    out = train_breakdown(args.model, args.batch, dtype=dtype, image_size=args.size,
                          remat=args.remat, ema=not args.no_ema, device=dev, iters=args.iters)
    for k, v in out["components"].items():
        print(json.dumps({"component": k, **v}), flush=True)
    out["summary"]["card"] = card() if dev.type == "cuda" else "cpu"
    print(json.dumps(out["summary"]), flush=True)
    return out


if __name__ == "__main__":
    main()
