"""Tile synthesis, a closed loop with one caller: ``Synthesizer.synthesize``
request after request, each on ``batch`` patient rows and a fresh seed.

The weights: the DCGAN generator and the frozen β-VAE from the seed, the
generator's running statistics set from one float32 train-mode pass over
standard-normal noise (as a trained generator holds them). The patients: a
pool of ``patients`` standard-normal expression rows; request i takes
``batch`` of them drawn with replacement from the seed, and the Philox seed
``seed_i``; every request has the same shapes. A request's latency is the host
time from the call until its uint8 tiles are on the device.

The comparison: ``sample_requests`` requests drawn from the seed among the
first ``sample_from``, and the window's last request, are held; after the
window the reference (float32 encode, the infused noise, the generator
unfolded in eval mode, tanh, x 255) judges each of their tiles.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench.core.bench import Unit
from perfbench.core.device import sync
from perfbench.core.seeds import derive
from perfbench.core.weights import calibrate_generator, dcgan_weights, vae_weights
from perfbench.counts import work
from perfbench.drivers import common
from perfbench.reference import draws, nets

#: requests the index table holds; request i takes row i modulo this
TABLE_REQUESTS = 8192
#: the faults its cells can have (``perfbench/faults.py``)
FAULTS = ("synth_altered_tile",)
#: the key of ``Runner.controls()`` that must fail the cell's limits: the generator in fp8, a step below bf16
CONTROL = "fp8"


def _altered_tile():
    """One served tile replaced by another where it is made."""
    from rnagan_tpu_torch.eval.generate import Synthesizer

    synthesize = Synthesizer.synthesize

    def broken(self, *a, **k):
        out = synthesize(self, *a, **k).clone()
        out[0] = out[1]
        return out
    return [(Synthesizer, "synthesize", broken)]


PATCHES = {"synth_altered_tile": _altered_tile}


class Runner:
    mark, per_unit = "tanh_to_uint8", 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.config, ctx.traffic
        self.m, self.vm = self.cfg["model"], self.cfg["vae"]
        self.batch = self.t["batch"]
        self.next = 0
        self.held: Dict[int, torch.Tensor] = {}
        self.last = None

    def _inputs(self):
        dev, m = self.ctx.device, self.m
        g_sd = dcgan_weights(m, derive(self.ctx.seed, "gan_weights"), dev)["G"]
        gen = torch.Generator(device=dev).manual_seed(derive(self.ctx.seed, "calibration"))
        with common.reference_numerics():
            calibrate_generator(g_sd, m, torch.randn((self.t["calibration_rows"], m["encoding_dims"]),
                                                     generator=gen, device=dev))
        vae_sd = vae_weights(self.vm, derive(self.ctx.seed, "vae_weights"), dev)
        pool = torch.randn((self.t["patients"], self.vm["rna_features"]), generator=gen, device=dev)
        return g_sd, vae_sd, pool

    def _plan(self):
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(derive(self.ctx.seed, "requests"))
        rows = torch.randint(0, self.t["patients"], (TABLE_REQUESTS, self.batch), generator=gen, device=dev)
        base = derive(self.ctx.seed, "request_seeds")
        picks = torch.randperm(self.t["sample_from"], generator=torch.Generator().manual_seed(base))
        return rows, base, sorted(int(i) for i in picks[:self.t["sample_requests"]])

    def request_seed(self, i: int) -> int:
        return (self.base + i) & 0x7FFFFFFF

    def setup(self) -> None:
        from rnagan_tpu_torch.eval.generate import Synthesizer

        g_sd, vae_sd, self.pool = self._inputs()
        self.rows, self.base, self.sample = self._plan()
        self.synth = Synthesizer(common.gan_config(self.cfg, self.batch, 0), vae_sd, g_sd, uint8_output=True,
                                 device=self.ctx.device)
        del g_sd, vae_sd
        common.free(self.ctx.device)
        for i in range(self.t["warmup_requests"]):
            self.synth.synthesize(self.pool[:self.batch], seed=i)
        sync(self.ctx.device)

    def _request(self) -> float:
        i = self.next
        self.next += 1
        gene = self.pool.index_select(0, self.rows[i % TABLE_REQUESTS])
        spans = self.ctx.spans
        t0 = time.perf_counter()
        with spans.span("request"):
            out = self.synth.synthesize(gene, seed=self.request_seed(i))
            sync(self.ctx.device)
        latency = time.perf_counter() - t0
        if i in self.sample:
            self.held[i] = out
        self.last = (i, out)
        return latency

    def unit(self) -> Unit:
        return Unit(1, self.batch, [self._request()])

    def profile_unit(self) -> int:
        for _ in range(self.t["profile_requests"]):
            self._request()
        return self.t["profile_requests"]

    def end_to_end(self, window) -> Dict[str, float]:
        from perfbench.core.bench import percentile

        return {"synth_tiles_per_s": window.work / window.seconds,
                "synth_request_p95_ms": 1e3 * percentile(window.latencies, 95.0)}

    def counts(self) -> Dict[str, float]:
        flops = work.synth_request_flops(self.m, self.vm, self.batch)
        return {"bf16_flop": flops["bf16"], "fp32_flop": flops["fp32"],
                "k2_bytes": work.k2_bytes(self.m, self.batch), "unit": "request"}

    def held_requests(self) -> Dict[int, torch.Tensor]:
        held = dict(self.held)
        if self.last is not None:
            held[self.last[0]] = self.last[1]
        return held

    def reference_tiles(self, i: int, g_sd, vae_sd, pool, q=nets.identity) -> torch.Tensor:
        """Request ``i``'s tiles as the reference makes them: float32 levels in [0, 255], NHWC."""
        gene = pool.index_select(0, self.rows[i % TABLE_REQUESTS])
        v_stats = nets.stats_list(vae_sd, [p for p, _ in nets.vae_specs(self.vm)[1]])
        g_stats = nets.stats_list(g_sd, [f"model.{k}.1." for k in range(nets.repeats(self.m["out_size"]) + 1)])
        with torch.no_grad(), common.reference_numerics():
            z = nets.z_mean_eval(vae_sd, v_stats, gene, self.vm)
            noise = draws.infused_noise(z, self.request_seed(i), self.cfg["train"]["noise_range"])
            pre, _ = nets.generator(g_sd, g_stats, noise, False, self.m, q)
        return ((torch.tanh(pre) * 0.5 + 0.5) * 255.0).permute(0, 2, 3, 1)

    def numbers(self, tiles: Dict[int, torch.Tensor], q=nets.identity) -> Dict[str, float]:
        """``tile_gap``: the worst tile's mean |served level - reference level|;
        ``pixel_gap``: the mean over every held tile's pixels."""
        g_sd, vae_sd, pool = self._inputs()
        worst, total, count = 0.0, 0.0, 0
        for i, served in sorted(tiles.items()):
            gap = (served.float() - self.reference_tiles(i, g_sd, vae_sd, pool, q)).abs()
            per_tile = gap.reshape(gap.shape[0], -1).mean(dim=1)
            worst = max(worst, float(per_tile.max()))
            total += float(gap.sum())
            count += gap.numel()
        return {"tile_gap": worst, "pixel_gap": total / count}

    def control_tiles(self, q) -> Dict[int, torch.Tensor]:
        """The held requests' tiles as the reference makes them with ``q``, served as uint8."""
        g_sd, vae_sd, pool = self._inputs()
        return {i: torch.clamp(self.reference_tiles(i, g_sd, vae_sd, pool, q) + 0.5, 0.0, 255.0).to(torch.uint8)
                for i in self.held_requests()}

    def release(self) -> None:
        for name in ("synth", "pool"):
            self.__dict__.pop(name, None)
        common.free(self.ctx.device)

    def check(self) -> Dict[str, float]:
        self.tiles = self.held_requests()
        self.release()
        return self.numbers(self.tiles)

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The numbers of the lower-precision control (the generator in fp8, a
        step below the stated bf16) and of one tile altered where it is made."""
        altered = dict(self.tiles)
        first = min(altered)
        altered[first] = altered[first].clone()
        altered[first][0] = altered[first][1]
        return {"fp8": self.numbers(self.control_tiles(nets.fp8_operands)), "altered_tile": self.numbers(altered)}
