"""Per-stage device time of a fused model: the stem and each of the four stages timed
alone at its own input, their sum beside the whole forward, and each section's kernel
launches.

Counterpart of ``recnext_tpu/benchmark/stage_breakdown.py``. A stage includes its
downsample, as the JAX tool's does; the head (the mean pool and the classifier) is
the forward's remainder. Each section's input is the previous section's output on a
random batch (``sections_forward`` chains them into the model's forward). Times are
CUDA events around queued calls (``tools/micro.py:timeit``). RecNeXt families
(M, A, L; fused, bf16). Runs on the GPU unless ``--device cpu``.

  python -m recnext_tpu_torch.tools.stage_breakdown --model recnext_m1 --batch 256
"""

from __future__ import annotations

import argparse
import json

import torch

from recnext_tpu_torch.tools.micro import _device, card, timeit


def kernel_counters() -> dict:
    """The launch counter of each kernel wrapper, by kernel name."""
    from recnext_tpu_torch.ops.attention import linear_attention_backward, linear_attention_fused
    from recnext_tpu_torch.ops.recconv import (rec_conv2d_backward, rec_conv2d_fused,
                                               rec_conv2d_level)

    return {"rec_conv2d": rec_conv2d_fused, "rec_conv2d_level": rec_conv2d_level,
            "linear_attention": linear_attention_fused,
            "rec_conv2d_backward": rec_conv2d_backward,
            "linear_attention_backward": linear_attention_backward}


def launches_of(fn) -> dict:
    """The kernel launches one call of ``fn`` makes (the counters are restored)."""
    counters = kernel_counters()
    before = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    try:
        fn()
        return {k: c.launches for k, c in counters.items()}
    finally:
        for k, c in counters.items():
            c.launches += before[k]


def sections(model) -> list:
    """[(name, callable)]: the stem, stages 0-3 (each with its downsample), the head."""
    def head(x):
        return model.head(x.float().mean(dim=(2, 3)).to(x.dtype))

    return ([("stem", model.stem)] + [(f"stage{i}", s) for i, s in enumerate(model.stages)]
            + [("head", head)])


def sections_forward(model, x: torch.Tensor) -> list:
    """The input of every section and, last, the logits: the model's forward cut at
    the sections."""
    outs = [x]
    for _, fn in sections(model):
        outs.append(fn(outs[-1]))
    return outs


def stage_breakdown(model_name: str, batch: int = 256, dtype=torch.bfloat16,
                    image_size: int = 224, device=None, iters: int = 20) -> dict:
    from recnext_tpu_torch.bench import inference_model

    dev = _device(device)
    model = inference_model(model_name, dtype, dev)
    x = torch.randn(batch, 3, image_size, image_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(0)).to(dtype)
    out = {"model": model_name, "batch": batch, "image_size": image_size,
           "dtype": str(dtype).replace("torch.", ""), "device": str(dev), "sections": {}}
    with torch.inference_mode():
        inputs = sections_forward(model, x)
        for (name, fn), inp in zip(sections(model), inputs):
            out["sections"][name] = {
                "input_shape": list(inp.shape),
                "launches": {k: v for k, v in launches_of(lambda: fn(inp)).items() if v},
                "ms": timeit(fn, inp, iters=iters, device=dev)}
        out["forward_ms"] = timeit(model, x, iters=iters, device=dev)
    out["sum_ms"] = sum(s["ms"] for s in out["sections"].values())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    dev = _device(args.device)
    res = stage_breakdown(args.model, args.batch, getattr(torch, args.dtype), args.image_size,
                          dev, args.iters)
    res["card"] = card() if dev.type == "cuda" else "cpu"
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
