"""The published BigGAN (arch ``biggan_pub``) trained through the path of
``rnagan gan-train --gan_type biggan_pub``: ``gan_fit``'s corpus, feed and
window (``GANTrainer.fit`` epoch after epoch over ``PatchBatches`` of a
host-resident corpus), with class labels, BigGAN's weights and its reference.

Each tile's label is its slide's index modulo ``num_classes`` (two tissue
CSVs at the configuration's 2 classes), and the batches carry it into G and
D at every stage. The weights are the published initialization drawn from
the seed (``reference/biggan.py::weights``). The comparison reads what
``gan_base`` reads, with the spectral norms' ``u`` vectors among the
statistics: after step 1 and as changes after the last first step.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from perfbench.core.seeds import derive
from perfbench.core.weights import load_into, vae_weights
from perfbench.counts import biggan as counts
from perfbench.drivers import common, gan_fit
from perfbench.drivers.gan_base import LOSSES, SCORES
from perfbench.reference import biggan, biggan_steps, data as ref_data, draws, nets

#: the faults its cells can have (``perfbench/faults.py``): ``gan_fit``'s corpus, feed and trainer, so its faults
FAULTS = gan_fit.FAULTS
#: the key of ``Runner.controls()`` that must fail the cell's limits: G and D in fp8, a step below bf16
CONTROL = "fp8"


def gan_config(cfg: dict, batch: int, seed: int):
    """The port's ``GANConfig`` of the configuration file (its ``model`` keys are ``GANModelConfig`` fields)."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig

    t = cfg["train"]
    return GANConfig(model=GANModelConfig(**cfg["model"]),
                     loss_type=t["loss_type"], batch_size=batch, g_lr=t["g_lr"], d_lr=t["d_lr"],
                     adam_b1=t["adam_b1"], adam_b2=t["adam_b2"], gp_lambda=t["gp_lambda"],
                     noise_range=t["noise_range"], vae=common.vae_model_config(cfg["vae"]), seed=seed)


class Runner(gan_fit.Runner):
    def _weights(self):
        dev = self.ctx.device
        return (biggan.weights(self.m, derive(self.ctx.seed, "gan_weights"), dev),
                vae_weights(self.vm, derive(self.ctx.seed, "vae_weights"), dev))

    def _stat_names(self) -> List[str]:
        return biggan.state_names(self.m)

    def _stats(self, state) -> Dict[str, torch.Tensor]:
        """The state's BatchNorm statistics and ``u`` vectors by the nets' buffer names."""
        out = {}
        for net, module, pairs in (("G", state.generator, state.g_stats), ("D", state.discriminator, state.d_stats)):
            names = {id(t): name for name, t in module.named_buffers()}
            for (a0, b0), (a, b) in zip(module.bn_stats(), pairs, strict=True):
                out[f"{net}.{names[id(a0)]}"] = a
                if names[id(a0)].endswith("running_mean"):
                    out[f"{net}.{names[id(b0)]}"] = b
        return out

    def _build(self) -> None:
        """The trainer and its state, holding the seed's weights and state."""
        from rnagan_tpu_torch.train.gan_trainer import GANTrainer

        w, vae_sd = self._weights()
        self.trainer = GANTrainer(gan_config(self.cfg, self.batch, self.program_seed), vae_state_dict=vae_sd,
                                  device=self.ctx.device)
        del vae_sd
        state = self.trainer.init_state()
        load_into(state.generator, w["G"])
        load_into(state.discriminator, w["D"])
        with torch.no_grad():
            for pairs, module in ((state.g_stats, state.generator), (state.d_stats, state.discriminator)):
                for (a, b), (a0, b0) in zip(pairs, module.bn_stats(), strict=True):
                    a.copy_(a0)
                    b.copy_(b0)
        self.state = state
        self._initial = {f"{net}.{k}": v for net in ("G", "D") for k, v in w[net].items()}

    def _labels(self, slide_idx: np.ndarray) -> np.ndarray:
        return (slide_idx % self.m["num_classes"]).astype(np.int32)

    def setup(self) -> None:
        from rnagan_tpu_torch.data.patches import PatchBatches, PatchData

        t = self.t
        images, rna = self._corpus()
        slide_idx = np.repeat(np.arange(t["slides"], dtype=np.int32), t["tiles_per_slide"])
        self.corpus = (images, rna, slide_idx)
        data = PatchData(images=images, labels=self._labels(slide_idx), slide_idx=slide_idx,
                         slides=[f"slide-{i}" for i in range(t["slides"])], rna=rna)
        self.batches = PatchBatches(data, batch_size=self.batch, with_rna=True, with_labels=True,
                                    seed=derive(self.ctx.seed, "order"))
        self._build()
        first = iter(list(itertools.islice(self.batches.epoch(0), t["check_steps"])))

        def run(n):
            out = []
            for b in itertools.islice(first, n):
                _, fitted = self.trainer.fit(lambda _e, b=b: iter([b]), num_epochs=1, state=self.state)
                out.append({k: fitted["history"][-1][k] for k in LOSSES + SCORES})
            return out
        self._read_first(run, [1] * t["check_steps"])

    def counts(self) -> Dict[str, float]:
        flops, attn = counts.step_flops(self.m, self.vm, self.batch), counts.attention_forwards(self.m, self.batch)
        return {"bf16_flop": flops["bf16"], "fp32_flop": flops["fp32"], "params": counts.params(self.m),
                "attn_flop": attn["flop"], "attn_bytes": attn["bytes"], "unit": "step"}

    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """``gan_fit``'s batches with each tile's label, by the reference's copy of the epoch order."""
        images, rna, slide_idx = self.corpus
        seed = derive(self.ctx.seed, "order")
        batches = ref_data.first_batches(images, rna, slide_idx, self.batch, self.t["check_steps"], seed,
                                         self.ctx.device)
        order = ref_data.epoch_order(len(images), seed, 0)
        labels = self._labels(slide_idx)
        for i, b in enumerate(batches):
            b["labels"] = torch.as_tensor(labels[order[i * self.batch:(i + 1) * self.batch]]).to(self.ctx.device)
        return batches

    def reference(self, q=nets.identity, half: bool = False, half_real: bool = False, no_gp: bool = False,
                  tiles_01: bool = False) -> dict:
        """``gan_base``'s reference readings, of ``reference/biggan_steps.py``'s steps."""
        w, vae_sd = self._weights()
        batches = self.reference_batches()
        if tiles_01:
            for b in batches:
                b["image"] = (b["image"] + 1.0) / 2.0
        seeds = [[draws.stream_seed(self.program_seed, "train", i, s) for s in range(4)]
                 for i in range(len(batches))]
        hp = common.gan_hp(self.cfg)
        if no_gp:
            hp["gp_lambda"] = 0.0
        with common.reference_numerics():
            ref = biggan_steps.gan_steps(w["G"], w["D"], vae_sd, batches, seeds, self.m, self.vm, hp, q=q,
                                         half=half, half_real=half_real)
        initial = {f"{net}.{k}": v for net in ("G", "D") for k, v in w[net].items()}
        return common.reference_readings(ref, initial, self._stat_names())
