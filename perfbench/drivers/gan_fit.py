"""RNA-GAN training through the path of ``rnagan gan-train``: ``GANTrainer.fit``
epoch after epoch over ``PatchBatches`` of a host-resident ``PatchData``.

The corpus: ``slides`` x ``tiles_per_slide`` uint8 tiles in host memory,
each with its own base colour and contrast (so a batch's real tiles differ
from each other, as stained tiles do, and the critic sees which were
loaded), and one standard-normal expression row a slide, all drawn from the
seed (on the device, then copied to the host). Each window unit is one
epoch, ``fit(epoch_fn, num_epochs=1, state=state)``, in the epoch order the
CLI's ``batches.epoch(epoch)`` gives.

Set-up runs the first ``check_steps`` steps through the same ``fit`` and
batches (one step a call, so each step's losses and the optimizer's state
after step 1 can be read), then hands the same state to the window. The
reference builds its own batches from the raw uint8 tiles
(``reference/data.py``), so the data plane's order and conversion are
compared too.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from perfbench.core.bench import Unit
from perfbench.core.seeds import derive
from perfbench.drivers.gan_base import LOSSES, SCORES, GANRunner
from perfbench.reference import data as ref_data

#: the faults its cells can have (``perfbench/faults.py``): the GAN step's, and the data plane's tiles in [0, 1]
FAULTS = ("gan_state_unchanged", "gan_half_batch", "gan_half_real", "gan_tiles_01")
#: the key of ``Runner.controls()`` that must fail the cell's limits: G and D in fp8, a step below bf16
CONTROL = "fp8"


def _tiles_01():
    """The data plane's uint8 tiles mapped to [0, 1] instead of [-1, 1]."""
    from rnagan_tpu_torch.data import patches

    def broken(images):
        return np.asarray(images, np.float32) / 255.0
    return [(patches, "tiles_to_float", broken)]


PATCHES = {"gan_tiles_01": _tiles_01}


class Runner(GANRunner):
    rate = "gan_train_samples_per_s"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.epoch = 1

    def _corpus(self):
        """Tiles that differ as stained tiles do: each its own base colour (a level
        a channel, uniform in ``tile_base``) and contrast (uniform in
        ``tile_contrast``), uniform noise of that amplitude around the base; drawn
        on the device a slide at a time and kept in host memory."""
        dev, t, m = self.ctx.device, self.t, self.m
        gen = torch.Generator(device=dev).manual_seed(derive(self.ctx.seed, "corpus"))
        per, c, size = t["tiles_per_slide"], m["out_channels"], m["out_size"]
        n = t["slides"] * per
        base = torch.empty((n, 1, 1, c), device=dev).uniform_(*t["tile_base"], generator=gen)
        amp = torch.empty((n, 1, 1, 1), device=dev).uniform_(*t["tile_contrast"], generator=gen)
        images = torch.empty((n, size, size, c), dtype=torch.uint8)
        for s in range(0, n, per):
            u = torch.rand((per, size, size, c), generator=gen, device=dev)
            tiles = (base[s:s + per] + amp[s:s + per] * (2.0 * u - 1.0)).round_().clamp_(0, 255)
            images[s:s + per] = tiles.to(torch.uint8).cpu()
        rna = torch.randn((t["slides"], self.vm["rna_features"]), generator=gen, device=dev).cpu().numpy()
        return images.numpy(), rna

    def setup(self) -> None:
        from rnagan_tpu_torch.data.patches import PatchBatches, PatchData

        t = self.t
        images, rna = self._corpus()
        slide_idx = np.repeat(np.arange(t["slides"], dtype=np.int32), t["tiles_per_slide"])
        self.corpus = (images, rna, slide_idx)
        data = PatchData(images=images, labels=np.zeros(len(images), np.int32), slide_idx=slide_idx,
                         slides=[f"slide-{i}" for i in range(t["slides"])], rna=rna)
        self.batches = PatchBatches(data, batch_size=self.batch, with_rna=True, seed=derive(self.ctx.seed, "order"))
        self._build()
        # the first steps, through the window's call and feed, one a call
        first = iter(list(itertools.islice(self.batches.epoch(0), t["check_steps"])))

        def run(n):
            out = []
            for b in itertools.islice(first, n):
                _, fitted = self.trainer.fit(lambda _e, b=b: iter([b]), num_epochs=1, state=self.state)
                out.append({k: fitted["history"][-1][k] for k in LOSSES + SCORES})
            return out
        self._read_first(run, [1] * t["check_steps"])

    # ----------------------------------------------------------------- window
    def _fit(self, limit=None) -> int:
        """One ``fit`` epoch (the first ``limit`` steps of it when given); returns its steps."""
        epoch, spans, steps = self.epoch, self.ctx.spans, 0
        self.epoch += 1

        def epoch_fn(_e):
            nonlocal steps
            it = self.batches.epoch(epoch)
            while limit is None or steps < limit:
                with spans.span("batch_wait"):
                    b = next(it, None)
                if b is None:
                    return
                steps += 1
                yield b

        step = self.trainer.train_step

        def entry(*a, **k):
            with spans.span("entry"):
                return step(*a, **k)
        if spans.active:
            self.trainer.train_step = entry
        try:
            self.trainer.fit(epoch_fn, num_epochs=1, state=self.state)
        finally:
            self.trainer.__dict__.pop("train_step", None)
        return steps

    def unit(self) -> Unit:
        steps = self._fit()
        return Unit(steps, steps * self.batch)

    def profile_unit(self) -> int:
        return self._fit(self.t["profile_steps"])

    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """Built from the raw uint8 tiles by the reference's own copy of the epoch order and conversion."""
        images, rna, slide_idx = self.corpus
        return ref_data.first_batches(images, rna, slide_idx, self.batch, self.t["check_steps"],
                                      derive(self.ctx.seed, "order"), self.ctx.device)
