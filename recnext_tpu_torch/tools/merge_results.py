"""Merge ``bench_all`` result files (say a batch-256 and a batch-512 sweep) into one
best-of-batch table.

Counterpart of ``recnext_tpu/benchmark/merge_results.py``: for each model the row
with the higher ``images_per_sec`` wins, the batch-1 ``latency_ms`` is carried over
from whichever input has it, error rows are dropped, and the order follows the
first file. ``--markdown`` prints the table, each number beside the card it was
measured on.

  python -m recnext_tpu_torch.tools.merge_results runs/b256.json runs/b512.json \
      --out runs/merged.json --markdown
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def merge(rows_lists):
    by, order = {}, []
    for rows in rows_lists:
        for r in rows:
            if "error" in r or "images_per_sec" not in r:
                continue
            name = r["model"]
            cur = by.get(name)
            if cur is None:
                by[name] = dict(r)
                order.append(name)
            elif r["images_per_sec"] > cur["images_per_sec"]:
                lat = cur.get("latency_ms")
                by[name] = dict(r)
                if lat is not None:
                    by[name].setdefault("latency_ms", lat)
            elif "latency_ms" in r:
                cur.setdefault("latency_ms", r["latency_ms"])
    return [by[n] for n in order]


def markdown_table(rows) -> str:
    has_lat = any("latency_ms" in r for r in rows)
    head = "| model | img/s | batch | card | RTX3090 img/s | ratio |"
    sep = "|---|---|---|---|---|---|"
    if has_lat:
        head += " batch-1 ms |"
        sep += "---|"
    lines = [head, sep]
    for r in rows:
        base = r.get("rtx3090_baseline")
        ratio = f"{r['vs_baseline']:.1f}x" if r.get("vs_baseline") else "-"
        line = (f"| {r['model']} | {r['images_per_sec']:.0f} | {r.get('batch', '-')} | "
                f"{r.get('device', '-')} | {base if base else '-'} | {ratio} |")
        if has_lat:
            lat = r.get("latency_ms")
            line += f" {lat:.2f} |" if lat is not None else " - |"
        lines.append(line)
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("inputs", nargs="+", help="bench_all output files")
    p.add_argument("--out", default="runs/bench_merged.json")
    p.add_argument("--markdown", action="store_true", help="print the table")
    args = p.parse_args(argv)
    rows = merge([json.loads(Path(f).read_text()) for f in args.inputs])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=2))
    print(f"wrote {args.out} ({len(rows)} models)")
    if args.markdown:
        print(markdown_table(rows))
    return rows


if __name__ == "__main__":
    main()
