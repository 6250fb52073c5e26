"""Metrics viewer CLI (copy of ``rnagan_tpu/cli/metrics.py``): inspect
``MetricsLogger`` JSONL runs from the terminal.

The reference logs through tensorboardX and inspects runs in TensorBoard
(reference ``betaVAE_training.py:169-176``); the sink of both packages is
line-delimited JSON (``core/metrics.py::MetricsLogger``). This viewer renders
those files with the standard library alone: per-tag summary tables,
single-metric history with an ASCII sparkline, and a PNG curve with
``--png``, which needs matplotlib (imported only then).

Usage:
  python -m rnagan_tpu_torch.cli.metrics run.jsonl                     # tag summary
  python -m rnagan_tpu_torch.cli.metrics run.jsonl --tag gan           # tag table
  python -m rnagan_tpu_torch.cli.metrics run.jsonl --tag gan --metric d_loss
  python -m rnagan_tpu_torch.cli.metrics run.jsonl --tag gan --metric fid --png out.png
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

SPARK = "▁▂▃▄▅▆▇█"


def load_records(path: str) -> List[Dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a live run
    return records


def sparkline(values: List[float]) -> str:
    finite = [v for v in values if v == v]  # drop NaN
    if not finite:
        return ""
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    return "".join(
        SPARK[int((v - lo) / span * (len(SPARK) - 1))] if v == v else "?"
        for v in values
    )


def summarize(records: List[Dict]) -> None:
    by_tag: Dict[str, List[Dict]] = {}
    for r in records:
        by_tag.setdefault(r.get("tag", "?"), []).append(r)
    print(f"{'tag':<16} {'rows':>6}  {'steps':>13}  metrics")
    for tag, rows in sorted(by_tag.items()):
        steps = [r.get("step", 0) for r in rows]
        keys = sorted({k for r in rows for k in r} - {"tag", "step", "t"})
        print(f"{tag:<16} {len(rows):>6}  {min(steps):>5}..{max(steps):<6}  {', '.join(keys)}")


def show_metric(records: List[Dict], tag: str, metric: str, png: str | None, width: int) -> int:
    rows = [r for r in records if r.get("tag") == tag and metric in r]
    if not rows:
        print(f"no rows with tag={tag!r} metric={metric!r}", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: r.get("step", 0))
    steps = [r.get("step", 0) for r in rows]
    values = [float(r[metric]) for r in rows]
    # downsample evenly for the terminal
    stride = max(len(values) // width, 1)
    print(f"{tag}/{metric}: n={len(values)} first={values[0]:.6g} "
          f"last={values[-1]:.6g} min={min(values):.6g} max={max(values):.6g}")
    print(sparkline(values[::stride]))
    if png:
        try:
            import matplotlib
        except ImportError as e:
            raise SystemExit("--png needs matplotlib, which is not installed; "
                             "drop --png for the terminal view") from e

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(steps, values, lw=1.5)
        ax.set_xlabel("step")
        ax.set_ylabel(metric)
        ax.set_title(f"{tag}/{metric}")
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(png, dpi=120)
        print(f"wrote {png}")
    return 0


def show_tag(records: List[Dict], tag: str, last: int) -> int:
    rows = [r for r in records if r.get("tag") == tag]
    if not rows:
        print(f"no rows with tag={tag!r}", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: r.get("step", 0))
    keys = sorted({k for r in rows for k in r} - {"tag", "step", "t"})
    print("step  " + "  ".join(f"{k:>12}" for k in keys))
    for r in rows[-last:]:
        cells = "  ".join(
            f"{r[k]:>12.5g}" if isinstance(r.get(k), (int, float)) else f"{'':>12}"
            for k in keys
        )
        print(f"{r.get('step', 0):<5} {cells}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("jsonl", help="MetricsLogger JSONL file")
    p.add_argument("--tag", help="filter to one tag (e.g. gan, train, val)")
    p.add_argument("--metric", help="plot one metric's history")
    p.add_argument("--png", help="also write a PNG curve (needs --metric)")
    p.add_argument("--last", type=int, default=20, help="rows to print for --tag tables")
    p.add_argument("--width", type=int, default=100, help="sparkline width")
    args = p.parse_args(argv)

    records = load_records(args.jsonl)
    if not records:
        print("no records", file=sys.stderr)
        return 1
    if args.metric:
        return show_metric(records, args.tag or "gan", args.metric, args.png, args.width)
    if args.tag:
        return show_tag(records, args.tag, args.last)
    summarize(records)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
