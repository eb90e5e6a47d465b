"""Model cards: a markdown card a variant with its architecture, the port's parameter
and MAC counts and, where a ``bench_all`` row is given, its measured throughput on
the card it was measured on (the card's name and power limit).

Counterpart of ``recnext_tpu/benchmark/modelcard.py`` (itself the reference's HF
publishing template): ``make_card`` for the RecNeXt families (BN-fused counts at
224²), ``make_mlla_card`` for the MLLA grafts (eval-mode counts at 256²). Counts
come from ``tools/flops.py`` (taken on the CPU, the plain path).

  python -m recnext_tpu_torch.tools.modelcard --model recnext_m1 --results runs/bench_all.json
  python -m recnext_tpu_torch.tools.modelcard --all --out runs/cards
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

TEMPLATE = """---
tags:
- image-classification
- recnext
library_name: recnext_tpu_torch
license: apache-2.0
---

# {name} (RecNeXt, PyTorch/CUDA port)

RecNeXt backbone ({family_long}) in PyTorch with hand-written CUDA kernels for the
NVIDIA H100. Paper: *RecConv: Efficient Recursive Convolutions for Multi-Frequency
Representations* (arXiv 2412.19628).

## Architecture

| field | value |
|---|---|
| family | {family} |
| embed_dim | {embed_dim} |
| depth | {depth} |
| mlp_ratio | {mlp_ratio} |
| params (fused) | {params_m:.2f} M |
| MACs @224 (fused) | {macs_g:.3f} G |
{extra_rows}
## Usage

```python
from recnext_tpu_torch.models.registry import create_model

model = create_model("{name}", fused=True)   # on the GPU
logits = model(images_nchw)
```
"""

FAMILY_LONG = {"m": "RecConv token mixer", "a": "RecAttn linear-attention mixer",
               "l": "LSNet-style partial-channel mixer"}

MLLA_TEMPLATE = """---
tags:
- image-classification
- recnext
library_name: recnext_tpu_torch
license: apache-2.0
---

# {name} (RecNeXt MLLA graft, PyTorch/CUDA port)

{variant_long} grafted into the MLLA (Swin-style) architecture, the reference's
ablation family. LayerNorm-based (no BN-fused form); native input 256².

## Architecture

| field | value |
|---|---|
| variant | {variant} |
| embed_dim | {embed_dim} |
| depths | {depths} |
| num_heads | {num_heads} |
| params | {params_m:.2f} M |
| MACs @256 | {macs_g:.3f} G |
{extra_rows}
## Training

`python -m recnext_tpu_torch.train.main --config configs/mlla_{size}_300e.yaml --model {name}`:
AdamW wd 0.05, global-norm clip 5.0, 20 warm-up epochs, MESA from 25% of training.
"""

MLLA_VARIANT_LONG = {
    "recconv": "RecConv2d aggregator (nearest x2 pyramid)",
    "recattn": "RoPE linear-attention RecAttn aggregator",
    "recattn_simple": "simplified (ELU+1, rope-free) RecAttn aggregator",
}


def _measured_rows(measured: dict | None, size: int, form: str) -> str:
    if not measured:
        return ""
    where = measured.get("device", "card not recorded")
    extra = ""
    if measured.get("images_per_sec"):
        extra += (f"| throughput ({form} @{measured.get('image_size', size)}, batch "
                  f"{measured.get('batch', '?')}; {where}) | "
                  f"{measured['images_per_sec']:.0f} img/s |\n")
    if measured.get("vs_baseline"):
        extra += f"| vs RTX3090 (reference fused img/s) | {measured['vs_baseline']:.1f}x |\n"
    if measured.get("latency_ms"):
        extra += f"| batch-1 latency ({form}; {where}) | {measured['latency_ms']:.2f} ms |\n"
    if measured.get("train_images_per_sec"):
        extra += (f"| train step (batch {measured.get('batch', '?')}; {where}) | "
                  f"{measured['train_images_per_sec']:.0f} img/s |\n")
    return extra


def make_card(model_name: str, throughput: float | None = None,
              measured: dict | None = None) -> str:
    """``measured``: the model's ``bench_all`` row (its ``device`` names the card)."""
    from recnext_tpu_torch.models.registry import get_config
    from recnext_tpu_torch.tools.flops import model_flops

    cfg = get_config(model_name)
    n_params, macs = model_flops(model_name, 224, fused=True)
    if throughput and not measured:
        measured = {"images_per_sec": throughput}
    return TEMPLATE.format(
        name=model_name, family=cfg.family, family_long=FAMILY_LONG[cfg.family],
        embed_dim=cfg.embed_dim, depth=cfg.depth, mlp_ratio=cfg.mlp_ratio,
        params_m=n_params / 1e6, macs_g=macs / 1e9,
        extra_rows=_measured_rows(measured, 224, "fused bf16"))


def make_mlla_card(model_name: str, measured: dict | None = None) -> str:
    from recnext_tpu_torch.models.mlla import MLLA_CONFIGS
    from recnext_tpu_torch.tools.flops import mlla_flops

    cfg = MLLA_CONFIGS[model_name]
    n_params, macs = mlla_flops(model_name)
    return MLLA_TEMPLATE.format(
        name=model_name, variant=cfg.variant, variant_long=MLLA_VARIANT_LONG[cfg.variant],
        embed_dim=cfg.embed_dim, depths=cfg.depths, num_heads=cfg.num_heads,
        params_m=n_params / 1e6, macs_g=macs / 1e9,
        extra_rows=_measured_rows(measured, 256, "bf16"),
        size="nano" if "nano" in model_name else "mini")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", help="one variant (or --all / --mlla-all)")
    p.add_argument("--all", action="store_true", help="every registry variant")
    p.add_argument("--mlla-all", action="store_true", help="the six MLLA grafts")
    p.add_argument("--out", default="runs/cards")
    p.add_argument("--throughput", type=float, default=None)
    p.add_argument("--results", default=None, help="a bench_all output")
    args = p.parse_args(argv)
    if sum([bool(args.model), args.all, args.mlla_all]) != 1:
        p.error("exactly one of --model / --all / --mlla-all")
    measured = {}
    if args.results:
        measured = {r["model"]: r for r in json.loads(Path(args.results).read_text())
                    if "error" not in r}
    if args.mlla_all:
        from recnext_tpu_torch.models.mlla import MLLA_CONFIGS

        names = sorted(MLLA_CONFIGS)
    elif args.all:
        from recnext_tpu_torch.models.registry import list_models

        names = list_models()
    else:
        names = [args.model]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in names:
        if name.startswith("mlla"):
            card = make_mlla_card(name, measured=measured.get(name))
        else:
            card = make_card(name, args.throughput, measured=measured.get(name))
        path = out / f"{name}.md"
        path.write_text(card)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
