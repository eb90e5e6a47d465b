"""Batch-occupancy scan: climb each model's power-of-two batch ladder until its
fused-inference throughput stops improving.

Counterpart of ``recnext_tpu/benchmark/occupancy_scan.py``: for each model, start
from its ``--results`` row (its batch and img/s, when given), measure each larger
batch of ``--batches`` and stop at the first that loses more than ``--tol`` against
the best so far. An out-of-memory error ends the model's climb and is recorded in
its row; it is not retried at a smaller size (the JAX tool's VMEM auto-split has no
counterpart). Rows are flushed to ``--out`` after every measurement; ``--resume``
reuses them. Runs on the GPU unless ``--device cpu``.

  python -m recnext_tpu_torch.tools.occupancy_scan --models recnext_m1 --out runs/occ.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch


def climb(name, batches, measure, *, best: float = 0.0, best_batch=None, tol: float = 0.01,
          done=None, rows=None, on_row=None):
    """Walk ``batches`` up for one model; ``measure(batch) -> img/s``. Returns the rows
    it added. ``done``: {batch: earlier row} reused without measuring."""
    added = []
    done = done or {}
    for batch in batches:
        if best_batch and batch <= best_batch:
            continue  # the starting row covers this point
        if batch in done:
            row = done[batch]
        else:
            row = {"model": name, "batch_requested": batch,
                   "measured_utc": time.strftime("%Y-%m-%d", time.gmtime())}
            try:
                row.update(images_per_sec=measure(batch), batch=batch)
            except torch.cuda.OutOfMemoryError as e:
                row["error"] = f"{type(e).__name__}: {e}"[:500]
                row["out_of_memory"] = True
            if best:
                row["vs_start"] = row.get("images_per_sec", 0.0) / best
            added.append(row)
            if on_row:
                on_row(row)
        if row.get("out_of_memory"):
            break
        ips = row.get("images_per_sec", 0.0)
        if ips > best:
            best, best_batch = ips, batch
        elif ips < best * (1.0 - tol):
            break  # past the knee
    return added


def main(argv=None):
    from recnext_tpu_torch import bench as bench_mod
    from recnext_tpu_torch.tools.micro import card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="+", default=["recnext_m1"])
    p.add_argument("--batches", type=int, nargs="+", default=[256, 512, 1024, 2048])
    p.add_argument("--timed", type=float, default=6.0)
    p.add_argument("--warmup", type=float, default=3.0)
    p.add_argument("--tol", type=float, default=0.01,
                   help="the relative loss that ends a model's climb")
    p.add_argument("--results", default=None,
                   help="a bench_all output: each model's starting batch and img/s")
    p.add_argument("--out", default="runs/occupancy.json")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    from recnext_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before the sweep, not a row a model
    start = {}
    if args.results and Path(args.results).exists():
        start = {r["model"]: r for r in json.loads(Path(args.results).read_text())
                 if "images_per_sec" in r}
    out = Path(args.out)
    rows = json.loads(out.read_text()) if args.resume and out.exists() else []
    where = card() if (args.device or "cuda").startswith("cuda") else "cpu"

    def flush(row):
        row["device"] = where
        rows.append(row)
        print(json.dumps(row), flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(rows, indent=2))
        os.replace(tmp, out)

    for name in args.models:
        base = start.get(name, {})
        done = {r["batch_requested"]: r for r in rows if r["model"] == name}

        def measure(batch, name=name):
            return bench_mod.throughput(name, batch, warmup_s=args.warmup,
                                        timed_s=args.timed, device=args.device)

        climb(name, args.batches, measure, best=float(base.get("images_per_sec", 0.0)),
              best_batch=base.get("batch"), tol=args.tol, done=done, on_row=flush)
    return rows


if __name__ == "__main__":
    main()
