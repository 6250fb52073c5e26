"""Faults planted in the program's timed path, for the tests and the readings.

Each is a way a later change could break a cell while it still runs: a step
that leaves the state unchanged (no optimizer update, the running statistics
written back as they were), half of each batch left out with the mean taken
over the rest, half of the GAN's real tiles left out (the first half read
twice in their place, so the critic's mean over the real tiles is the first
half's), the data plane's tiles mapped to [0, 1] instead of [-1, 1], and an
answer altered where it is made (one served tile replaced by another). ``plant(name)``
patches the port's classes until the context ends.
"""

from __future__ import annotations

import contextlib


def _unchanged_adam(self, params, grads, lr=None, corr=None):
    self.count += 1


def _unchanged_schedule(self, params, grads, row=None, variant=None):
    self.count += 1


def _kept(tensors, step, *args):
    """``step(*args)`` with ``tensors`` written back as they were before it."""
    import torch

    saved = [t.detach().clone() for t in tensors]
    out = step(*args)
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    return out


def _unchanged_gan_step(step):
    def broken(self, state, *args):
        stats = [t for pair in state.g_stats + state.d_stats for t in pair]
        return _kept(stats, step, self, state, *args)
    return broken


def _unchanged_vae_step(step):
    def broken(self, state, *args):
        return _kept([b for n, b in state.model.named_buffers() if "running" in n], step, self, state, *args)
    return broken


def _half_gan_step(step):
    def broken(self, state, batch, draws, seeds, corr, run_g):
        n = batch["image"].shape[0]
        return step(self, state, {k: v[:n // 2] for k, v in batch.items()}, draws, seeds, corr, run_g)
    return broken


def _half_real_gan_step(step):
    def broken(self, state, batch, draws, seeds, corr, run_g):
        import torch

        image = batch["image"]
        half = torch.cat([image[:len(image) // 2]] * 2)
        return step(self, state, {**batch, "image": half}, draws, seeds, corr, run_g)
    return broken


def _tiles_01(images):
    import numpy as np

    return np.asarray(images, np.float32) / 255.0


def _half_vae_step(step):
    def broken(self, state, x, m, draws, seeds, row, variant):
        return step(self, state, x[:len(x) // 2], m[:len(x) // 2], draws, seeds, row, variant)
    return broken


def _altered_tile(synthesize):
    def broken(self, *a, **k):
        out = synthesize(self, *a, **k).clone()
        out[0] = out[1]
        return out
    return broken


def _patches(name):
    from rnagan_tpu_torch.data import patches
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.optim.adam import Adam
    from rnagan_tpu_torch.optim.scheduled import ScheduledOptimizer
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    return {"gan_state_unchanged": [(Adam, "step", _unchanged_adam),
                                    (GANTrainer, "_step", _unchanged_gan_step(GANTrainer._step))],
            "gan_half_batch": [(GANTrainer, "_step", _half_gan_step(GANTrainer._step))],
            "gan_half_real": [(GANTrainer, "_step", _half_real_gan_step(GANTrainer._step))],
            "gan_tiles_01": [(patches, "tiles_to_float", _tiles_01)],
            "vae_state_unchanged": [(ScheduledOptimizer, "step", _unchanged_schedule),
                                    (VAETrainer, "_step", _unchanged_vae_step(VAETrainer._step))],
            "vae_half_batch": [(VAETrainer, "_step", _half_vae_step(VAETrainer._step))],
            "synth_altered_tile": [(Synthesizer, "synthesize", _altered_tile(Synthesizer.synthesize))]}[name]


#: the faults each driver's cells can have
FAULTS = {"gan_fit": ("gan_state_unchanged", "gan_half_batch", "gan_half_real", "gan_tiles_01"),
          "gan_quality": ("gan_state_unchanged", "gan_half_batch", "gan_half_real"),
          "vae_resident": ("vae_state_unchanged", "vae_half_batch"),
          "synthesize": ("synth_altered_tile",)}


@contextlib.contextmanager
def plant(name: str):
    patches = _patches(name)
    originals = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    for owner, attr, broken in patches:
        setattr(owner, attr, broken)
    try:
        yield
    finally:
        for owner, attr, original in originals:
            setattr(owner, attr, original)
