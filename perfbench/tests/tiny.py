"""Tiny widths and mixes for the CPU tests: every cell through the plain paths in seconds.

The noise keeps 512 columns: a batch cut in half changes the generator's
running statistics by an amount that grows with the noise's width (its
columns standardized over fewer rows), which the GAN cell's comparison reads.
"""

import time

import torch

from perfbench.core import bench, spec

TINY = {"config": {"model": {"out_size": 32, "step_channels": 4, "encoding_dims": 512},
                   "vae": {"rna_features": 40, "z_dim": 512, "encoder_dims": [24, 20, 16], "decoder_dims": [20, 24]}},
        "traffic": {"batch": 4, "slides": 2, "tiles_per_slide": 8, "rows": 40, "chunk_steps": 5, "patients": 10,
                    "sample_from": 5, "sample_requests": 2, "calibration_rows": 8, "warmup_requests": 1,
                    "profile_steps": 2, "profile_requests": 2}}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 977


def run(name: str, seed: int = SEED, seconds: float = 0.5, bench_root=None, base=None) -> dict:
    b = spec.load_benchmark(bench_root or spec.ROOT)
    cell = spec.Cell(b, name, base=base or spec.HERE)
    return bench.run(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter(), shrink=TINY,
                     log=lambda s: None)


def runner(name: str, seed: int = SEED):
    """The cell's runner at tiny widths on the CPU, set up and through the units its comparison holds."""
    cell = spec.Cell(spec.load_benchmark(), name)
    ctx = bench.Context(spec.merge(cell.config, TINY["config"]), spec.merge(cell.traffic, TINY["traffic"]), seed,
                        torch.device("cpu"), bench.Spans(False))
    r = cell.driver().Runner(ctx)
    r.setup()
    for _ in range(ctx.traffic.get("sample_from", -1) + 1):
        r.unit()
    return r
