"""Sweep the port's benchmark over the model zoo and write a results table: fused
inference img/s (with ``--latency`` the batch-1 ms), or with ``--train`` the train
step's img/s (median of ``--repeats`` windows and their spread).

Counterpart of ``recnext_tpu/benchmark/bench_all.py`` over the port's ``bench.py``
(``throughput``, ``latency_ms``, ``train_throughput``). Rows are flushed to ``--out``
after every model (atomically); ``--resume`` keeps every earlier row of ``--out``
and runs again only the listed models that are missing or errored. A model that
fails becomes an error row carrying its exception, and the sweep goes on. Each row
names the card and its power limit. The JAX CLI's ``--compile-cache`` has no
counterpart in PyTorch. Runs on the GPU unless ``--device cpu``.

  python -m recnext_tpu_torch.tools.bench_all --models recnext_m0 recnext_m1 --latency
  python -m recnext_tpu_torch.tools.bench_all --train --batch 128 --out runs/train.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

DEFAULT_OUT = "runs/bench_all.json"  # git-ignored: never a file of the repository


def main(argv=None):
    from recnext_tpu_torch import bench as bench_mod
    from recnext_tpu_torch.tools.micro import card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="+", default=["recnext_m0", "recnext_m1"])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--timed", type=float, default=6.0)
    p.add_argument("--warmup", type=float, default=3.0)
    p.add_argument("--image-size", type=int, default=0,
                   help="0 = the model's native side (224; MLLA 256)")
    p.add_argument("--latency", action="store_true", help="also the batch-1 ms a forward")
    p.add_argument("--train", action="store_true",
                   help="the train step's img/s instead of fused inference")
    p.add_argument("--repeats", type=int, default=3,
                   help="--train: timed windows a model; the median and the spread")
    p.add_argument("--stamp", default="", help="a provenance label written in every row")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--resume", action="store_true",
                   help="keep --out's rows; run only the models missing or errored there")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    if args.train and args.latency:
        p.error("--latency measures the fused inference forward and is not defined for "
                "--train rows; run two sweeps")
    from recnext_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before the sweep, not a row a model
    out = Path(args.out)
    rows = []
    if args.resume and out.exists():
        rows = [r for r in json.loads(out.read_text())
                if not (r["model"] in args.models and "error" in r)]
    done = {r["model"] for r in rows}
    gpu = (args.device or "cuda").startswith("cuda")
    where = card() if gpu else "cpu"
    for name in args.models:
        if name in done:
            continue
        size = args.image_size or bench_mod.native_size(name)
        row = {"model": name, "image_size": size, "device": where,
               "measured_utc": time.strftime("%Y-%m-%d", time.gmtime())}
        if args.stamp:
            row["stamp"] = args.stamp
        try:
            if args.train:
                ips, used, spread = bench_mod.train_throughput(
                    name, args.batch, timed_s=args.timed, image_size=size,
                    repeats=args.repeats, device=args.device)
                row.update(train_images_per_sec=ips, batch=used, spread=spread)
            else:
                ips = bench_mod.throughput(name, args.batch, warmup_s=args.warmup,
                                           timed_s=args.timed, image_size=size,
                                           device=args.device)
                row.update(images_per_sec=ips, batch=args.batch)
                base = bench_mod.BASELINES.get(name) if size == 224 else None
                if base:
                    row["rtx3090_baseline"] = base
                    row["vs_baseline"] = ips / base
                if args.latency:
                    row["latency_ms"] = bench_mod.latency_ms(name, image_size=size,
                                                             device=args.device)
        except Exception as e:  # the sweep goes on; --resume runs the model again
            row["error"] = f"{type(e).__name__}: {e}"[:500]
        rows.append(row)
        print(json.dumps(row), flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(rows, indent=2))
        os.replace(tmp, out)
    return rows


if __name__ == "__main__":
    main()
