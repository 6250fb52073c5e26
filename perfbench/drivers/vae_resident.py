"""β-VAE training on a matrix resident on the card: ``VAETrainer.run_resident``
chunk after chunk.

The matrix: ``rows`` standard-normal rows of ``rna_features`` genes drawn
from the seed on the device. Each window unit is one chunk,
``run_resident(state, data, chunk_steps, batch)``: every step draws its
``batch`` rows with replacement from its own seed. Set-up runs the first
``check_steps`` steps on the graph the window replays: ``run_resident``'s
own ``run_steps`` with its ``prepare`` and the chunk's capacity, one step,
then the rest in one load (so the optimizer's state after step 1 can be
read, and the device counter walks the table's rows); then one whole chunk,
and hands the same state on.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import faults
from perfbench.core import compare
from perfbench.core.bench import Unit
from perfbench.core.device import sync
from perfbench.core.seeds import derive
from perfbench.core.weights import load_into, vae_weights
from perfbench.counts import work
from perfbench.drivers import common
from perfbench.reference import draws, nets, train_steps

#: the control (TF32 products, a step below the stated float32 with TF32 off) and the planted fault
CONTROLS = {"tf32": dict(q=nets.tf32_operands), "half_batch": dict(half=True)}
#: the faults its cells can have (``perfbench/faults.py``)
FAULTS = ("vae_state_unchanged", "vae_half_batch")
#: the key of ``Runner.controls()`` that must fail the cell's limits
CONTROL = "tf32"


def _state_unchanged():
    """No optimizer update, and the running statistics written back as they were."""
    from rnagan_tpu_torch.optim.scheduled import ScheduledOptimizer
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    step = VAETrainer._step

    def broken(self, state, *args):
        return faults.kept([b for n, b in state.model.named_buffers() if "running" in n], step, self, state, *args)
    return [(ScheduledOptimizer, "step", faults.unchanged_optimizer), (VAETrainer, "_step", broken)]


def _half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    step = VAETrainer._step

    def broken(self, state, x, m, draws, seeds, row, variant):
        return step(self, state, x[:len(x) // 2], m[:len(x) // 2], draws, seeds, row, variant)
    return [(VAETrainer, "_step", broken)]


PATCHES = {"vae_state_unchanged": _state_unchanged, "vae_half_batch": _half_batch}


class Runner:
    mark, per_unit = "fused_adam", 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.config, ctx.traffic
        self.vm, self.train = self.cfg["vae"], self.cfg["train"]
        self.batch, self.chunk = self.t["batch"], self.t["chunk_steps"]
        self.program_seed = derive(ctx.seed, "program")

    def _data(self) -> torch.Tensor:
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(derive(self.ctx.seed, "matrix"))
        return torch.randn((self.t["rows"], self.vm["rna_features"]), generator=gen, device=dev)

    def _weights(self):
        return vae_weights(self.vm, derive(self.ctx.seed, "vae_weights"), self.ctx.device)

    def _stat_names(self) -> List[str]:
        return [prefix + k for prefix, _ in nets.vae_specs(self.vm)[1] for k in ("running_mean", "running_var")]

    def setup(self) -> None:
        from rnagan_tpu_torch.core.config import VAEConfig
        from rnagan_tpu_torch.train.vae_trainer import VAETrainer

        dev, tr = self.ctx.device, self.train
        cfg = VAEConfig(model=common.vae_model_config(self.vm), lr=tr["lr"], batch_size=self.batch,
                        warmup_steps=tr["warmup_steps"], cosine_steps=tr["cosine_steps"], seed=self.program_seed)
        self.trainer = VAETrainer(cfg, device=dev)
        self.data = self._data()
        state = self.trainer.init_state()
        sd = self._weights()
        load_into(state.model, sd)
        self.state = state
        # the window's run_resident(state, data, chunk, batch) is run_steps on its "draw" prepare at capacity chunk:
        # the first steps replay that graph (run_resident itself would cap the capacity at a call's steps)
        prepare = self.trainer._prepare("draw", self.data, self.batch)
        first = self.trainer.run_steps(state, {}, prepare, 1, capacity=self.chunk)
        b1 = state.opt.rule.b1
        grad_norms = compare.norms({k: mu / (1.0 - b1) for (k, _), mu in
                                    zip(state.model.named_parameters(), state.opt.rule.mu)})
        rest = self.trainer.run_steps(state, {}, prepare, self.t["check_steps"] - 1, capacity=self.chunk)
        losses = [{"total_loss": float(v)} for v in torch.cat([first, rest])[:, 0].tolist()]
        params = dict(state.model.named_parameters())
        buffers = dict(state.model.named_buffers())
        names = self._stat_names()
        self.readings = {"losses": losses, "grads": grad_norms, "change": compare.change_norms(params, sd),
                         "stats": compare.change_norms({k: buffers[k] for k in names}, sd)}
        del sd, params, buffers
        common.free(dev)
        self.trainer.run_resident(state, self.data, self.chunk, self.batch)  # a whole chunk before the window

    def _chunk(self) -> int:
        with self.ctx.spans.span("entry"):
            self.trainer.run_resident(self.state, self.data, self.chunk, self.batch)
        sync(self.ctx.device)
        return self.chunk

    def unit(self) -> Unit:
        steps = self._chunk()
        return Unit(steps, steps * self.batch)

    def profile_unit(self) -> int:
        return self._chunk()

    def end_to_end(self, window) -> Dict[str, float]:
        return {"vae_train_samples_per_s": window.work / window.seconds}

    def counts(self) -> Dict[str, float]:
        flops = work.vae_step_flops(self.vm, self.batch)
        return {"bf16_flop": flops["bf16"], "fp32_flop": flops["fp32"], "params": work.vae_params(self.vm),
                "unit": "step"}

    def reference(self, q=nets.identity, half: bool = False) -> dict:
        sd, data = self._weights(), self._data()
        seeds = [[draws.stream_seed(self.program_seed, "train", i, s) for s in range(3)]
                 for i in range(self.t["check_steps"])]
        hp = dict(lr=self.train["lr"], warmup_steps=self.train["warmup_steps"],
                  cosine_steps=self.train["cosine_steps"], beta=self.vm["beta"])
        with common.reference_numerics():
            ref = train_steps.vae_steps(sd, data, seeds, self.batch, self.vm, hp, q=q, half=half)
        return common.reference_readings(ref, sd, self._stat_names())

    def release(self) -> None:
        for name in ("trainer", "state", "data"):
            self.__dict__.pop(name, None)
        common.free(self.ctx.device)

    def check(self) -> Dict[str, float]:
        self.release()
        self.ref = self.reference()
        return compare.training_numbers(self.readings, self.ref, ("total_loss",))

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The numbers of the lower-precision control and of each planted fault,
        put in the program's place (after :meth:`check`)."""
        return {name: compare.training_numbers(self.reference(**kw), self.ref, ("total_loss",))
                for name, kw in CONTROLS.items()}
