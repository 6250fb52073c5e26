"""What the RNA-GAN training drivers share: the trainer built from the seed's
weights, the readings of the first steps, the reference's steps and the
comparison's numbers. A driver adds its corpus, how a step goes through the
window's own call, the window's unit and the reference's real tiles.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from perfbench import faults
from perfbench.core import compare
from perfbench.core.seeds import derive
from perfbench.core.weights import dcgan_weights, load_into, vae_weights
from perfbench.counts import work
from perfbench.drivers import common
from perfbench.reference import draws, nets, train_steps

LOSSES = ("d_loss", "gp", "g_loss")
#: the first step's losses that are continuous in the scores (the penalty reads their gradients)
FIRST_LOSSES = ("d_loss", "g_loss")
#: the critic's mean scores on the real tiles and the fakes (D forward alone at the first step)
SCORES = ("dx", "dgz")
#: the control (G and D in fp8, a step below the stated bf16) and the faults the readings plant in the reference
CONTROLS = {"fp8": dict(q=nets.fp8_operands), "half_batch": dict(half=True), "half_real": dict(half_real=True),
            "no_gp": dict(no_gp=True), "tiles_01": dict(tiles_01=True)}


def _state_unchanged():
    """No optimizer update, and G's and D's running statistics written back as they were."""
    from rnagan_tpu_torch.optim.adam import Adam
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    step = GANTrainer._step

    def broken(self, state, *args):
        stats = [t for pair in state.g_stats + state.d_stats for t in pair]
        return faults.kept(stats, step, self, state, *args)
    return [(Adam, "step", faults.unchanged_optimizer), (GANTrainer, "_step", broken)]


def _half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    step = GANTrainer._step

    def broken(self, state, batch, draws, seeds, corr, run_g):
        n = batch["image"].shape[0]
        return step(self, state, {k: v[:n // 2] for k, v in batch.items()}, draws, seeds, corr, run_g)
    return [(GANTrainer, "_step", broken)]


def _half_real():
    """Half of the real tiles left out, the first half read twice in their place
    (so the critic's mean over the real tiles is the first half's)."""
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    step = GANTrainer._step

    def broken(self, state, batch, draws, seeds, corr, run_g):
        image = batch["image"]
        half = torch.cat([image[:len(image) // 2]] * 2)
        return step(self, state, {**batch, "image": half}, draws, seeds, corr, run_g)
    return [(GANTrainer, "_step", broken)]


#: the faults of a GAN step that every GAN driver can have (``perfbench/faults.py``)
PATCHES = {"gan_state_unchanged": _state_unchanged, "gan_half_batch": _half_batch, "gan_half_real": _half_real}


class GANRunner:
    mark, per_unit = "fused_adam", 2
    #: the end-to-end rate the driver's cells report
    rate = ""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.config, ctx.traffic
        self.m, self.vm = self.cfg["model"], self.cfg["vae"]
        self.batch = self.t["batch"]
        self.program_seed = derive(ctx.seed, "program")

    def _weights(self):
        dev = self.ctx.device
        return (dcgan_weights(self.m, derive(self.ctx.seed, "gan_weights"), dev),
                vae_weights(self.vm, derive(self.ctx.seed, "vae_weights"), dev))

    def _stat_names(self) -> List[str]:
        return [f"{net}.{prefix}{k}" for net, prefix, _ in nets.dcgan_specs(self.m)[1]
                for k in ("running_mean", "running_var")]

    def _stats(self, state) -> Dict[str, torch.Tensor]:
        return dict(zip(self._stat_names(), [t_ for pair in state.g_stats + state.d_stats for t_ in pair]))

    def _build(self) -> None:
        """The trainer and its state, holding the seed's weights and statistics."""
        from rnagan_tpu_torch.train.gan_trainer import GANTrainer

        w, vae_sd = self._weights()
        self.trainer = GANTrainer(common.gan_config(self.cfg, self.batch, self.program_seed),
                                  vae_state_dict=vae_sd, device=self.ctx.device)
        del vae_sd
        state = self.trainer.init_state()
        load_into(state.generator, w["G"])
        load_into(state.discriminator, w["D"])
        with torch.no_grad():
            for stats, module in ((state.g_stats, state.generator), (state.d_stats, state.discriminator)):
                for (mean, var), (m0, v0) in zip(stats, module.bn_stats(), strict=True):
                    mean.copy_(m0)
                    var.copy_(v0)
        self.state = state
        self._initial = {f"{net}.{k}": v for net in ("G", "D") for k, v in w[net].items()}

    def _read_first(self, run: Callable[[int], List[Dict[str, float]]], counts: List[int]) -> None:
        """The first steps through ``run(n)``, the window's own call, which runs the
        next ``n`` steps and returns each one's losses (``counts``: the ``n`` of
        each call, the first 1); the optimizer's first gradient and the
        statistics are read after step 1, the changes after the last."""
        state, initial = self.state, self._initial
        losses = run(counts[0])
        b1 = state.g_opt.b1
        grads = {**{"G." + k: mu / (1.0 - b1) for (k, _), mu in
                    zip(state.generator.named_parameters(), state.g_opt.mu)},
                 **{"D." + k: mu / (1.0 - b1) for (k, _), mu in
                    zip(state.discriminator.named_parameters(), state.d_opt.mu)}}
        grad_norms = compare.norms(grads)
        del grads
        stats1 = compare.change_norms(self._stats(state), initial)
        for n in counts[1:]:
            losses += run(n)
        params = {**{"G." + k: p for k, p in state.generator.named_parameters()},
                  **{"D." + k: p for k, p in state.discriminator.named_parameters()}}
        self.readings = {"losses": losses, "grads": grad_norms, "change": compare.change_norms(params, initial),
                         "stats": compare.change_norms(self._stats(state), initial), "stats1": stats1}
        del self._initial, params
        common.free(self.ctx.device)

    def end_to_end(self, window) -> Dict[str, float]:
        return {self.rate: window.work / window.seconds}

    def counts(self) -> Dict[str, float]:
        flops = work.gan_step_flops(self.m, self.vm, self.batch)
        return {"bf16_flop": flops["bf16"], "fp32_flop": flops["fp32"], "params": work.dcgan_params(self.m),
                "unit": "step"}

    # ------------------------------------------------------------- comparison
    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The first steps' batches as the reference builds them: ``image``
        float32 NHWC in [-1, 1] and ``rna_data``, on the device."""
        raise NotImplementedError

    def reference(self, q=nets.identity, half: bool = False, half_real: bool = False, no_gp: bool = False,
                  tiles_01: bool = False) -> dict:
        """The reference's readings of the first steps (``q``, ``half``,
        ``half_real``, ``no_gp``, ``tiles_01``: a control or a planted fault;
        ``no_gp`` drops the gradient penalty from D's loss, ``tiles_01`` maps
        the real tiles to [0, 1] instead of [-1, 1])."""
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
            ref = train_steps.gan_steps(w["G"], w["D"], vae_sd, batches, seeds, self.m, self.vm, hp, q=q, half=half,
                                        half_real=half_real)
        initial = {f"{net}.{k}": v for net in ("G", "D") for k, v in w[net].items()}
        return common.reference_readings(ref, initial, self._stat_names())

    def release(self) -> None:
        for name in ("trainer", "state", "batches"):
            self.__dict__.pop(name, None)
        common.free(self.ctx.device)

    @staticmethod
    def numbers(prog: dict, ref: dict) -> Dict[str, float]:
        """The comparison's numbers (``core/compare.py``), and ``d_loss1_gap``:
        the first step's critic loss alone, D's forward passes over the real
        tiles and the fakes at the initial weights. ``stats1_gap`` reads G's and
        D's running statistics after step 1: G's two passes, D's over the real
        tiles and the fakes and, after D's update, over the G stage's fakes."""
        out = compare.training_numbers(prog, ref, LOSSES, FIRST_LOSSES, SCORES)
        out["d_loss1_gap"] = compare.loss_gap(prog["losses"][:1], ref["losses"][:1], ("d_loss",))
        return out

    def check(self) -> Dict[str, float]:
        self.release()
        self.ref = self.reference()
        return self.numbers(self.readings, self.ref)

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The numbers of the lower-precision control and of each planted fault,
        put in the program's place (after :meth:`check`)."""
        return {name: self.numbers(self.reference(**kw), self.ref) for name, kw in CONTROLS.items()}
