"""RNA-GAN training as the quality run dispatches it: ``GANTrainer.run_steps``
chunk after chunk, each step's batch rendered on the card inside the step's
CUDA graph from its (slide, tile) ids (``tools/quality_run_torch.py``).

The corpus is the procedural H&E one (``data/synthetic.py::SyntheticCorpus``)
at ``slides`` x ``tiles_per_slide``, its seed drawn from ``--seed``. Each
slide's expression row is a standard-normal row the benchmark draws (the
tool's host-side normalization of the corpus's expression is not part of a
step). Each window unit is one ``run_steps`` call of ``chunk_steps`` steps
at capacity ``chunk_steps``; the ids of every step come from
``corpus.batch_ids`` under one key, rows in order, so no two steps share
them. Set-up runs the first ``check_steps`` steps through the same call and
graph (one step, then the rest in one load), which captures it, and hands
the same state to the window. The reference renders the real tiles itself
(``reference/render.py``) from ids it draws with its own copy of the draw.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.core.bench import Unit
from perfbench.core.device import sync
from perfbench.core.seeds import derive
from perfbench.drivers.gan_base import GANRunner
from perfbench.reference import render

#: the faults its cells can have (``perfbench/faults.py``): the GAN step's (it bypasses the host data plane)
FAULTS = ("gan_state_unchanged", "gan_half_batch", "gan_half_real")
#: the key of ``Runner.controls()`` that must fail the cell's limits: G and D in fp8, a step below bf16
CONTROL = "fp8"


class Runner(GANRunner):
    rate = "quality_train_samples_per_s"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.corpus_seed = derive(ctx.seed, "corpus")
        self.ids_key = derive(ctx.seed, "ids")
        self.row = 0

    def _rna(self) -> torch.Tensor:
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(derive(self.ctx.seed, "rna"))
        return torch.randn((self.t["slides"], self.vm["rna_features"]), generator=gen, device=dev)

    def setup(self) -> None:
        from rnagan_tpu_torch.data.synthetic import SyntheticCorpus
        from rnagan_tpu_torch.train.gan_trainer import METRICS

        t, dev = self.t, self.ctx.device
        corpus = SyntheticCorpus(n_slides=t["slides"], tiles_per_slide=t["tiles_per_slide"],
                                 n_genes=self.vm["rna_features"], size=self.m["out_size"], seed=self.corpus_seed,
                                 device=dev)
        rna = self._rna()

        def prepare(rows):
            sl = rows["slide"]
            return {"image": corpus.render(sl, rows["tile"]), "rna_data": rna[sl]}
        self.corpus, self.prepare = corpus, prepare
        self._build()
        keys = [k for k in METRICS if k in self.trainer.metric_keys()]

        def run(n):
            """``n`` (1 or 2) steps; run_steps returns the last one's losses, ``sums`` their sum."""
            sums = torch.zeros(len(keys), device=dev)
            last = self._steps(n, sums)
            return [dict(zip(keys, v.tolist())) for v in ([last] if n == 1 else [sums - last, last])]
        self._read_first(run, [1, t["check_steps"] - 1])

    def _steps(self, n: int, sums=None) -> torch.Tensor:
        """The next ``n`` steps in one ``run_steps`` call on the window's graph."""
        sl, ti = self.corpus.batch_ids(self.ids_key, self.batch, n, start=self.row)
        self.row += n
        return self.trainer.run_steps(self.state, {"slide": sl, "tile": ti}, self.prepare, n, sums=sums,
                                      capacity=self.t["chunk_steps"])

    # ----------------------------------------------------------------- window
    def _chunk(self, n: int) -> int:
        with self.ctx.spans.span("entry"):
            self._steps(n)
        sync(self.ctx.device)
        return n

    def unit(self) -> Unit:
        steps = self._chunk(self.t["chunk_steps"])
        return Unit(steps, steps * self.batch)

    def profile_unit(self) -> int:
        return self._chunk(self.t["profile_steps"])

    def release(self) -> None:
        for name in ("corpus", "prepare"):
            self.__dict__.pop(name, None)
        super().release()

    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The first steps' tiles rendered by the reference's own copy of the corpus."""
        t, dev = self.t, self.ctx.device
        latents = render.slide_latents(self.corpus_seed, t["slides"], render.TISSUES, dev)
        sl, ti = render.batch_ids(self.ids_key, self.batch, t["check_steps"], t["slides"], t["tiles_per_slide"], dev)
        stride = t["tiles_per_slide"] + render.HELDOUT_SPAN
        rna = self._rna()
        return [{"image": render.render(self.corpus_seed, latents[sl[i]], ti[i] + sl[i] * stride, self.m["out_size"]),
                 "rna_data": rna[sl[i]]} for i in range(t["check_steps"])]
