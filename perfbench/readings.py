"""The readings a cell's limits are set from, on the card at the cell's own sizes.

    python3 perfbench/readings.py --workload <cell> --seeds <n> [--first <seed>] [--list <seed> ...]

For each seed: the cell's set-up (the program's first steps, or a short run
of requests that covers the held ones), the comparison's numbers of the
program, then of the lower-precision control and of each fault put in the
reference in the program's place (the drivers' ``controls()``); with
``--plant`` the program's numbers with a fault planted in it instead (any
fault a file under ``perfbench/drivers/`` defines: ``perfbench/faults.py``).
One JSON line a seed, then the largest program reading and the smallest
control and fault reading of each number. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_000)
    p.add_argument("--list", type=int, nargs="*", help="these seeds instead of --seeds from --first")
    p.add_argument("--plant", default=None, help="a fault that a file under perfbench/drivers/ defines, planted in the program")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import faults
    from perfbench.core import bench, device, spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    device.require_cards(cell.entry["chips"])
    dev = torch.device("cuda", 0)
    rows = []
    for seed in args.list or [args.first + 7919 * k for k in range(args.seeds)]:
        t0 = time.perf_counter()
        ctx = bench.Context(cell.config, cell.traffic, seed, dev, bench.Spans(False))
        runner = cell.driver().Runner(ctx)
        with faults.plant(args.plant) if args.plant else contextlib.nullcontext():
            runner.setup()
            for _ in range(cell.traffic.get("sample_from", -1) + 1):
                runner.unit()
        if args.plant:
            row = {"seed": seed, "program": runner.check(), "seconds": time.perf_counter() - t0}
        else:
            row = {"seed": seed, "program": runner.check(), **runner.controls(), "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del runner
        device.sync(dev)
    summary = {"lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for name in rows[0]:
        if name not in ("seed", "program", "seconds"):
            summary[name] = {k: min(r[name][k] for r in rows) for k in rows[0][name]}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
