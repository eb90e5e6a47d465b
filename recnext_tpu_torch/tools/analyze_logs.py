"""Training-log analysis: curves of a metric, epoch-time statistics, the best value.

Counterpart of ``recnext_tpu/benchmark/analyze_logs.py`` (mmcv's ``plot_curve``,
mmdet's ``cal_train_time``). Reads the JSON lines of the port's trainer
(``train/main.py``'s epoch lines: ``epoch``, ``train_s``, ``train_images_per_sec``)
and task CLIs (``iter`` / ``epoch`` keyed), and those of the JAX package's CLIs
(``epoch_time_s``, ``elapsed_s``, ``images_per_sec``); other lines (warnings,
progress) are skipped, so a captured stdout works too. matplotlib is imported by
``plot_curve`` alone.

  python -m recnext_tpu_torch.tools.analyze_logs cal_train_time runs/m1/log.txt
  python -m recnext_tpu_torch.tools.analyze_logs best runs/m1/log.txt --keys test_acc1
  python -m recnext_tpu_torch.tools.analyze_logs plot_curve runs/m1/log.txt --keys train_loss --out loss.png
"""

from __future__ import annotations

import argparse
import json
from typing import List

# (seconds of a record, images a second of a record): the port's keys, then JAX's
TIME_KEYS = ("train_s", "epoch_time_s")
RATE_KEYS = ("train_images_per_sec", "images_per_sec")


def load_records(path: str) -> List[dict]:
    """Every JSON object line of a log; other lines are skipped."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _x_axis(records: List[dict]):
    """(name, values): epoch-keyed logs plot against epoch, iter-keyed against iter."""
    if records and "epoch" in records[0]:
        return "epoch", [r.get("epoch", i) for i, r in enumerate(records)]
    if records and "iter" in records[0]:
        return "iter", [r.get("iter", i) for i, r in enumerate(records)]
    return "step", list(range(len(records)))


def _first_key(records, keys):
    return next((k for k in keys if any(k in r for r in records)), None)


def train_time(records: List[dict]) -> dict:
    """Seconds a record (mean, p50, min, max) and the mean img/s of a log."""
    out = {"records": len(records)}
    key = _first_key(records, TIME_KEYS)
    if key:
        times = [r[key] for r in records if key in r]
    else:  # iter-keyed logs record the cumulative elapsed_s
        elapsed = [r["elapsed_s"] for r in records if "elapsed_s" in r]
        times = [b - a for a, b in zip(elapsed, elapsed[1:]) if b >= a]
    if times:
        ts = sorted(times)
        out.update(time_mean_s=sum(times) / len(times), time_p50_s=ts[len(ts) // 2],
                   time_min_s=ts[0], time_max_s=ts[-1])
    rate = _first_key(records, RATE_KEYS)
    if rate:
        ips = [r[rate] for r in records if rate in r]
        out["images_per_sec_mean"] = sum(ips) / len(ips)
    return out


def cal_train_time(args) -> list:
    outs = []
    for path in args.json_logs:
        out = {"log": path, **train_time(load_records(path))}
        print(json.dumps(out))
        outs.append(out)
    return outs


def best(args) -> list:
    """The largest value of each key and the epoch (or iter) it came at."""
    outs = []
    for path in args.json_logs:
        records = load_records(path)
        _, xs = _x_axis(records)
        for key in args.keys:
            pts = [(v[key], x) for x, v in zip(xs, records) if key in v]
            out = {"log": path, "key": key, "best": None}
            if pts:
                val, at = max(pts)
                out.update(best=val, at=at)
            print(json.dumps(out))
            outs.append(out)
    return outs


def plot_curve(args) -> None:
    import matplotlib

    if args.out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    legends = args.legend or [f"{p}:{k}" for p in args.json_logs for k in args.keys]
    if len(legends) != len(args.json_logs) * len(args.keys):
        raise SystemExit("--legend must have len(json_logs) * len(keys) entries")
    ax = plt.gca()
    xlabel = "step"
    for i, path in enumerate(args.json_logs):
        records = load_records(path)
        xlabel, xs = _x_axis(records)
        for j, key in enumerate(args.keys):
            pts = [(x, r[key]) for x, r in zip(xs, records) if key in r]
            if not pts:
                print(f"{path}: no records with key {key!r}")
                continue
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", markersize=3,
                    label=legends[i * len(args.keys) + j])
    ax.set_xlabel(xlabel)
    ax.legend()
    if args.title:
        ax.set_title(args.title)
    if args.out is None:
        plt.show()
    else:
        plt.savefig(args.out, dpi=120, bbox_inches="tight")
        print(f"saved curve to {args.out}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Analyze JSON-lines training logs")
    sub = parser.add_subparsers(dest="task", required=True)
    for name in ("plot_curve", "cal_train_time", "best"):
        p = sub.add_parser(name)
        p.add_argument("json_logs", nargs="+")
        if name != "cal_train_time":
            p.add_argument("--keys", nargs="+", default=["test_acc1"])
        if name == "plot_curve":
            p.add_argument("--title", default=None)
            p.add_argument("--legend", nargs="+", default=None)
            p.add_argument("--out", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return {"plot_curve": plot_curve, "cal_train_time": cal_train_time,
            "best": best}[args.task](args)


if __name__ == "__main__":
    main()
