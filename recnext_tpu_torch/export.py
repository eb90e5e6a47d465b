"""Publishing and export: the BN-fused archive the server loads, and programs saved
by ``torch.export``.

Counterpart of ``recnext_tpu/export.py``.

* ``publish_fused``: an archive is a directory holding ``<model>_fused.pt``, a
  ``torch.save`` of the fused torch-layout state dict, and ``<model>_meta.json``.
  That is the layout ``python -m recnext_tpu.export --to-torch`` writes (a
  ``{"model": state_dict}`` wrapping is accepted too), so a model trained with the
  JAX package is served by the port unchanged.
* ``export_program``: ``torch.export`` of the fused forward (the MLLA family's
  unfused one, at 256^2) at a fixed batch, saved as ``<model>_b<batch>.pt2``: the
  counterpart of ``export_stablehlo``. K1 and K2 are one node each
  (``recnext::rec_conv2d``, ``recnext::linear_attention_nchw``: ``ops/__init__.py``),
  so the program launches the same kernels as the eager model on the GPU and runs
  their plain versions on the CPU. It loads with ``load_program`` (or
  ``torch.export.load`` after importing ``recnext_tpu_torch.ops``).
* ``sha_stamp``, ``import_torch_and_publish`` and the CLI, ``python -m
  recnext_tpu_torch.export``, with the JAX CLI's flags; ``--torch-export`` takes the
  place of ``--stablehlo``:

    python -m recnext_tpu_torch.export --model recnext_m1 --ckpt runs/m1/ckpt/epoch_0299.pt \\
        --ema --out published --batch 8 --torch-export --sha-stamp --to-torch m1_fused.pth

  ``--torch-ckpt`` reads a reference ``.pth`` (or any file ``train/finetune.py:
  read_weights`` reads, the JAX package's ``.msgpack`` too), ``--ckpt`` this trainer's
  checkpoint (its EMA weights with ``--ema``); without either the weights are a
  seeded init. ``--to-torch`` writes the fused state dict (``--torch-unfused``: the
  unfused one). Fusion runs on the CPU, where it gives the JAX package's bits.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Mapping

import torch

from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.registry import get_config


def publish_fused(model_name: str, state_dict: Mapping[str, torch.Tensor],
                  out_path: str) -> Path:
    """Fuse an unfused model's state dict and write <out>/<model>_fused.pt + meta.json."""
    fused = fuse_params({k: v.cpu() for k, v in state_dict.items()})
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    f = out / f"{model_name}_fused.pt"
    torch.save(fused, f)
    cfg = get_config(model_name)
    (out / f"{model_name}_meta.json").write_text(json.dumps({
        "model": model_name, "family": cfg.family, "embed_dim": cfg.embed_dim,
        "depth": cfg.depth, "num_classes": cfg.num_classes, "fused": True,
    }, indent=2))
    return f


def resolve_published_path(model_name: str, path: str) -> Path:
    """Resolve an archive dir (or direct file path) to the published file, falling
    back to the newest sha-stamped ``<model>_fused-<sha8>.pt``."""
    p = Path(path)
    if p.is_dir():
        f = p / f"{model_name}_fused.pt"
        if not f.exists():
            # newest by mtime: the sha8 infix is content-derived, so a
            # lexicographic sort would pick an arbitrary one
            stamped = sorted(p.glob(f"{model_name}_fused-*.pt"),
                             key=lambda q: q.stat().st_mtime)
            if stamped:
                f = stamped[-1]
        p = f
    return p


def load_published(model_name: str, path: str) -> Dict[str, torch.Tensor]:
    """The fused state dict for ``create_model(model_name, fused=True)``, on the CPU."""
    state = torch.load(resolve_published_path(model_name, path), map_location="cpu",
                       weights_only=True)
    if set(state) == {"model"}:
        state = state["model"]
    return state


def _is_mlla(model_name: str) -> bool:
    return model_name.startswith("mlla")


def export_program(model_name: str, state_dict: Mapping[str, torch.Tensor] | None = None, *,
                   batch: int = 1, input_size: int = 0, dtype: torch.dtype = torch.bfloat16,
                   fused: bool = True, device=None, out_path: str | None = None):
    """``torch.export`` of the model's forward on (batch, 3, S, S) images in ``dtype``
    on ``device`` (default: the GPU): the fused model from a fused ``state_dict``
    (unfused with ``fused=False``), or the MLLA family's unfused model (S 256 unless
    ``input_size``; ``fused`` does not apply). Without ``state_dict`` the weights are
    a seeded init. No parameter requires a gradient, so each RecConv2d mixer and
    linear attention is one custom-op node. Saved to ``out_path`` where given; returns
    the ``ExportedProgram``."""
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model

    dev = resolve_device(device)
    # the classifier's width from the weights (a model trained on another class count)
    heads = [v for k, v in (state_dict or {}).items()
             if k in ("head.weight", "head.head.linear.weight")]
    kw = {"num_classes": int(heads[0].shape[0])} if heads else {}
    if _is_mlla(model_name):
        model = create_mlla(model_name, device=dev, dtype=dtype, **kw)
        input_size = input_size or model.cfg.img_size
    else:
        input_size = input_size or 224
        model = create_model(model_name, fused=fused, device=dev, dtype=dtype, **kw)
        if state_dict is None and fused:
            state_dict = fuse_params(create_model(model_name, device="cpu").state_dict())
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval().requires_grad_(False)
    x = torch.zeros(batch, 3, input_size, input_size, dtype=dtype, device=dev)
    program = torch.export.export(model, (x,))
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        torch.export.save(program, out_path)
    return program


def load_program(path: str):
    """A program ``export_program`` saved, as a module to call (the custom ops
    registered first)."""
    import recnext_tpu_torch.ops  # noqa: F401  (registers recnext::*)

    return torch.export.load(path).module()


def sha_stamp(artifact: Path) -> Path:
    """Content-address a published artifact: rename it to <stem>-<sha8><suffix> and
    record the full digest in the sibling meta.json."""
    digest = hashlib.sha256(artifact.read_bytes()).hexdigest()
    stamped = artifact.with_name(f"{artifact.stem}-{digest[:8]}{artifact.suffix}")
    artifact.rename(stamped)
    meta = artifact.parent / f"{artifact.stem.replace('_fused', '')}_meta.json"
    if meta.exists():
        m = json.loads(meta.read_text())
        m.update(sha256=digest, artifact=stamped.name)
        meta.write_text(json.dumps(m, indent=2))
    return stamped


def import_torch_and_publish(model_name: str, torch_ckpt: str, out_path: str) -> Path:
    """A reference ``.pth`` checkpoint -> fused -> the published archive."""
    from recnext_tpu_torch.train.finetune import read_weights

    return publish_fused(model_name, read_weights(torch_ckpt, ema=False), out_path)


def _weights(args) -> Dict[str, torch.Tensor]:
    """The unfused weights the CLI publishes, on the CPU."""
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train.finetune import read_weights

    if args.torch_ckpt:
        return read_weights(args.torch_ckpt, ema=False)
    if args.ckpt:
        return read_weights(args.ckpt, ema=args.ema)
    make = create_mlla if _is_mlla(args.model) else create_model
    return make(args.model, device="cpu").state_dict()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("publish / export a model (PyTorch/CUDA port)")
    p.add_argument("--model", required=True)
    p.add_argument("--torch-ckpt", default="", help=".pth to import (else a seeded init)")
    p.add_argument("--ckpt", default="", help="a checkpoint of the port's trainer")
    p.add_argument("--ema", action="store_true", help="export --ckpt's EMA weights")
    p.add_argument("--out", default="published")
    p.add_argument("--torch-export", action="store_true",
                   help="also write <out>/<model>_b<batch>.pt2 (torch.export)")
    p.add_argument("--stablehlo", action="store_true",
                   help="the JAX CLI's StableHLO export; the port's is --torch-export")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="the exported program's dtype")
    p.add_argument("--device", default=None,
                   help="device of the exported program (default: the GPU)")
    p.add_argument("--sha-stamp", action="store_true", help="content-address the archive")
    p.add_argument("--to-torch", default="",
                   help="also write a reference-loadable .pth (fused layout, or the "
                        "training layout with --torch-unfused)")
    p.add_argument("--torch-unfused", action="store_true",
                   help=".pth in the unfused training layout instead of the fused one")
    args = p.parse_args(argv)
    if args.stablehlo:
        raise SystemExit("--stablehlo is the JAX package's export; the port writes a "
                         "torch.export program with --torch-export")
    if args.torch_export and torch.device(args.device or "cuda").type == "cuda":
        from recnext_tpu_torch.utils.watchdog import require_devices

        require_devices(metric="export")  # a deadline on the first touch of the GPU
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    out_dir = Path(args.out)
    variables = _weights(args)
    program = out_dir / f"{args.model}_b{args.batch}.pt2"

    if _is_mlla(args.model):
        # the MLLA grafts have no BatchNorm past the stem and no fused archive: the
        # deployables are the program and the reference-layout state dict
        if not (args.to_torch or args.torch_export):
            raise SystemExit("mlla models have no fused published artifact; pass "
                             "--torch-export and/or --to-torch")
        out_dir.mkdir(parents=True, exist_ok=True)
        if args.to_torch:
            torch.save(variables, args.to_torch)
            print(f"exported torch checkpoint {args.to_torch} (mlla layout)")
        if args.torch_export:
            export_program(args.model, variables, batch=args.batch, dtype=dtype,
                           device=args.device, out_path=str(program))
            print(f"exported {program}")
        return

    f = publish_fused(args.model, variables, args.out)
    if args.sha_stamp:
        f = sha_stamp(f)
    print(f"published {f}")
    if args.to_torch:
        state = variables if args.torch_unfused else load_published(args.model, args.out)
        torch.save(state, args.to_torch)
        print(f"exported torch checkpoint {args.to_torch} "
              f"({'unfused' if args.torch_unfused else 'published-fused'} layout)")
    if args.torch_export:
        export_program(args.model, load_published(args.model, args.out), batch=args.batch,
                       dtype=dtype, device=args.device, out_path=str(program))
        print(f"exported {program}")


if __name__ == "__main__":
    main()
