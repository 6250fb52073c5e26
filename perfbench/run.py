"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. Standard
error gets the card's clocks beside the window and, as its last lines, each
number of the comparison beside its limit; the last line of standard output
is the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: every build and kernel cache of the program, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "triton", "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core import bench, device, spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    device.require_cards(cell.entry["chips"])
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), STARTED)
    found = bench.banned_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
