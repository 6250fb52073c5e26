#!/usr/bin/env python3
"""The GAN training step of several checkouts of this repository, on one card.

    python3 tools/ab_gan_step.py OLD_ROOT . . OLD_ROOT

For each root, in the order given, a child process imports that checkout's
``chip_smoke.py`` and ``rnagan_tpu_torch`` and runs its full-width
``GANConfig()`` training path (wganvae, bfloat16): 10 steps at batch 8 after
3 of warm-up (``train_main_path``), 3 profiled steps (device busy time and
wall time a step) and 5 steps at batch 64. Each prints one line ``AB
{json}``. Alternating the roots in one call separates a change's effect from
the spread between machines: the batch-8 step is host-bound. Needs CUDA.
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import inspect, json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import rnagan_tpu_torch
from rnagan_tpu_torch.core.config import VAEModelConfig
from rnagan_tpu_torch.models.betavae import BetaVAE
assert cs.__file__.startswith(root) and rnagan_tpu_torch.__file__.startswith(root)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
vae = BetaVAE(VAEModelConfig(), seed=1, device=dev)
cs.randomize(vae, gen)
sd = vae.state_dict()
del vae
tr, st, batches, training = cs.train_main_path(dev, gen, sd)
if "tr" in inspect.signature(cs.profile_training).parameters:  # an older signature
    prof = cs.profile_training(tr, st, batches[0])
else:
    prof = cs.profile_training(lambda: tr.train_step(st, batches[0]))
del tr, st, batches
training.update(cs.train_step_ms_b64(dev, gen, sd))
print("AB " + json.dumps({"root": root, "step_ms_b8": training["step_ms_b8"],
                          "step_ms_b64": training["step_ms_b64"],
                          "device_busy_ms_b8": prof.get("device_busy_ms_per_step"),
                          "wall_ms_b8_profiled": prof.get("wall_ms_per_step")}))
"""


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)], capture_output=True,
                             text=True, timeout=600)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not lines:
            print(res.stdout[-2000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
