"""Op-by-op breakdown of the A family's block (RecAttn2d + MLP) at the packed executor's
shapes, on the GPU.

Counterpart of ``recnext_tpu/benchmark/attn_breakdown.py``. Each part runs the modules
of one packed fused ``MetaNeXtBlockA`` (``models/packed_infer.py:packed_block``, seeded
weights) at a stage's packed shape, timed with CUDA events over calls queued on the card
(``tools/micro.py:timeit``):

  down      the stride-2 5x5 depthwise conv into the attention
  qk_conv   the 1x1 q/k projection (2g groups)
  qk_elu    projection + feature map
  split     the free (B, 2c, H, W) and (B, c, H, W) views of the packed qk and v
  la_head   the attention, one launch of K2 over B * heads heads (the plain version on
            the CPU)
  pe_conv   the 3x3 depthwise positional term
  resize    the nearest x2 upsample (``ops/resize.py:resize``)
  out_conv  the 5x5 depthwise conv over x + up(attn)
  mlp       the block's 1x1 MLP (g groups) + GELU
  block     the whole packed block (block - the sum of the parts: the fusion credit, or
            the tax between ops)

JAX's ``la_blkdiag``, ``la_blk_fus`` and ``resize_m`` time TPU layouts of the same
functions that the port does not have (ROADMAP.md, Queue 1, "Not ported, on purpose"):
they are printed as null with that reason. Stage groups: ``--groups`` or
``default_groups``. Runs on the GPU unless ``--device cpu`` (the host's clock then);
prints the card's name and power limit.

  python -m recnext_tpu_torch.tools.attn_breakdown --model recnext_a1 --stages 1 2 \\
      --groups 2,2,2,2 --out attn_breakdown_a1.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from recnext_tpu_torch.tools.micro import _device, card, timeit

NOT_PORTED = {name: "a TPU layout of the same function, not ported (ROADMAP.md, Queue 1, "
                    "'Not ported, on purpose')"
              for name in ("la_blkdiag", "la_blk_fus", "resize_m")}


def stage_shapes(model_name: str, batch: int, groups=None, image_size: int = 224):
    """[(stage, packed batch, side, packed channels, heads, g)] at ``groups`` (default:
    ``default_groups``)."""
    from recnext_tpu_torch.models.packed_infer import default_groups
    from recnext_tpu_torch.models.registry import get_config

    cfg = get_config(model_name)
    if cfg.family != "a":
        raise ValueError(f"{model_name}: attn_breakdown times the A family's block")
    groups = tuple(groups) if groups else default_groups(cfg, batch)
    side = image_size // 4
    return cfg, [(i, batch // g, side >> i, c * g, 2 ** (i + 1), g)
                 for i, (c, g) in enumerate(zip(cfg.embed_dim, groups))]


def breakdown_stage(model_name: str, stage: int, batch: int = 256, groups=None,
                    image_size: int = 224, dtype=torch.bfloat16, iters: int = 50,
                    device=None) -> dict:
    from recnext_tpu_torch.models.packed_infer import _PackedAttention, packed_block
    from recnext_tpu_torch.models.recnext import MetaNeXtBlockA, init_weights
    from recnext_tpu_torch.ops.attention import feature_map, linear_attention_fused
    from recnext_tpu_torch.ops.resize import resize

    dev = _device(device)
    cfg, shapes = stage_shapes(model_name, batch, groups, image_size)
    i, b, side, cg, heads, g = shapes[stage]
    c = cg // g
    block = MetaNeXtBlockA(c, cfg.mlp_ratio[i], stage=i, attn_kernel=cfg.attn_kernel,
                           fused=True)
    init_weights(block, torch.Generator().manual_seed(stage))
    blk = packed_block(block.to(dev, dtype).eval(), g)
    down, attn = blk.token_mixer.down
    if g == 1:  # the block as it is: its attention through the same views, at g = 1
        attn = _PackedAttention(attn, 1)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(b, cg, side, side, device=dev, generator=gen).to(dtype)
    with torch.inference_mode():
        yd = down(x)
        qk = feature_map(attn.qk(yd), attn.kernel)
        n, h, w = b * g, yd.shape[2], yd.shape[3]

        def split(qk_, v_):
            return qk_.view(n, 2 * c, h, w), v_.view(n, c, h, w)

        o = attn.attention(qk, yd)
        parts = {
            "down": lambda: down(x),
            "qk_conv": lambda: attn.qk(yd),
            "qk_elu": lambda: feature_map(attn.qk(yd), attn.kernel),
            "split": lambda: split(qk, yd),
            "la_head": lambda: attn.attention(qk, yd),
            "pe_conv": lambda: attn.pe(yd),
            "resize": lambda: resize(o, (side, side), mode="nearest"),
            "out_conv": lambda: blk.token_mixer.conv(x),
            "mlp": lambda: blk.channel_mixer(x),
            "block": lambda: blk(x),
        }
        ms = {name: timeit(fn, iters=iters, device=dev) for name, fn in parts.items()}
        launches = linear_attention_fused.launches
        blk(x)
        block_k2 = linear_attention_fused.launches - launches
    comp_sum = sum(ms[k] for k in ("down", "qk_elu", "la_head", "pe_conv", "resize",
                                   "out_conv", "mlp"))
    return {"model": model_name, "stage": i, "batch_packed": b, "side": side,
            "c_packed": cg, "heads": heads, "g": g, "variant": attn.variant,
            "dtype": str(dtype).replace("torch.", ""), "device": str(dev),
            "k2_launches_per_block": block_k2, "ms": {**ms, **dict.fromkeys(NOT_PORTED)},
            "not_ported": NOT_PORTED, "sum_parts_ms": comp_sum,
            "inter_op_tax_ms": ms["block"] - comp_sum}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="recnext_a1")
    p.add_argument("--stages", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--groups", default="", help="per-stage factors, e.g. 2,2,2,2 "
                                                "(default: default_groups)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    dev = _device(args.device)
    print(json.dumps({"device": str(dev), "card": card() if dev.type == "cuda" else "cpu"}),
          flush=True)
    groups = tuple(int(v) for v in args.groups.split(",")) if args.groups else None
    rows = []
    for s in args.stages:
        row = breakdown_stage(args.model, s, args.batch, groups, args.image_size,
                              iters=args.iters, device=dev)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
