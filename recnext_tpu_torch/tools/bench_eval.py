"""The in-training evaluation step, unfused against BN-fused, on the GPU.

Counterpart of ``recnext_tpu/benchmark/bench_eval.py``: the reference evaluates the
raw model every epoch; the port's trainer evaluates through BN-fused weights
(``train/step.py:make_fused_eval_step`` folds the state's weights each call). Both
steps are timed on the same state and batch with CUDA events over queued calls; the
JAX tool's ``packed`` flavour waits for the packed executor (ROADMAP Queue 1 item
12). RecNeXt families (M, A, L). Runs on the GPU unless ``--device cpu``.

  python -m recnext_tpu_torch.tools.bench_eval --model recnext_m1 --batch 256
"""

from __future__ import annotations

import argparse
import json

import torch

from recnext_tpu_torch.tools.micro import _device, card, timeit


def bench_eval(model_name: str, batch: int = 256, image_size: int = 224, iters: int = 10,
               dtype=torch.bfloat16, device=None, **overrides) -> dict:
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_eval_step, make_fused_eval_step

    dev = _device(device)
    model = create_model(model_name, device=dev, generator=torch.Generator().manual_seed(0),
                         **overrides)
    state = TrainState.create(model, make_optimizer(model.named_parameters(),
                                                    cosine_schedule(1e-3, 1000)))
    gen = torch.Generator(dev).manual_seed(0)
    nc = model.cfg.num_classes
    data = {"image": torch.randn(batch, 3, image_size, image_size, device=dev, generator=gen),
            "label": torch.arange(batch, device=dev) % nc}
    unfused = make_eval_step(model, dtype=dtype)
    fused = make_fused_eval_step(model.cfg, dtype=dtype)
    unfused_ms = timeit(unfused, state, data, iters=iters, device=dev)
    fused_ms = timeit(fused, state, data, iters=iters, device=dev)
    return {"model": model_name, "batch": batch, "image_size": image_size, "device": str(dev),
            "unfused_eval_ms_per_batch": unfused_ms, "fused_eval_ms_per_batch": fused_ms,
            "unfused_images_per_sec": batch / unfused_ms * 1e3,
            "fused_images_per_sec": batch / fused_ms * 1e3,
            "speedup": unfused_ms / fused_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    dev = _device(args.device)
    rec = bench_eval(args.model, args.batch, args.image_size, args.iters, device=dev)
    rec["card"] = card() if dev.type == "cuda" else "cpu"
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
