"""``rnagan`` dispatcher of the port (the command table of
``rnagan_tpu/cli/main.py``, pointing at ``rnagan_tpu_torch.cli.*``):

    python -m rnagan_tpu_torch.cli.main <command> [args]

Device-taking commands read ``--device`` (default ``cuda``) where the JAX
ones read ``--platform``; ``metrics`` and ``tile`` run on the host and take
neither. ``metrics`` joins the table, which the JAX dispatcher leaves to
``python -m rnagan_tpu.cli.metrics``.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "betavae-train": ("rnagan_tpu_torch.cli.betavae_train", "betaVAE training (betaVAE_training.py)"),
    "gan-train": ("rnagan_tpu_torch.cli.gan_train", "GAN / RNA-GAN training (histopathology_gan.py)"),
    "generate": ("rnagan_tpu_torch.cli.generate", "tile synthesis (generate_tissue_images.py)"),
    "fid": ("rnagan_tpu_torch.cli.fid", "FID evaluation (fid.py)"),
    "sample": ("rnagan_tpu_torch.cli.sample", "expression sampling (betaVAE_sample.py)"),
    "interpolate": ("rnagan_tpu_torch.cli.interpolate", "latent interpolation (betaVAE_interpolation.py)"),
    "representation": ("rnagan_tpu_torch.cli.representation",
                       "per-patient representations (compute_representation.py)"),
    "ml-experiment": ("rnagan_tpu_torch.cli.ml_experiment", "downstream classification (ml_experiments.py)"),
    "tile": ("rnagan_tpu_torch.cli.tile", "WSI preprocessing (patch_gen_grid.py)"),
    "metrics": ("rnagan_tpu_torch.cli.metrics", "MetricsLogger JSONL viewer"),
    "export-torch": ("rnagan_tpu_torch.cli.export_torch", "GAN checkpoint <-> torchgan .model conversion"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: rnagan <command> [args]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:16s} {desc}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}")
        return 2
    # a command's main returns its results for programmatic use; the exit
    # code stays 0 unless it raises, as the JAX dispatcher's
    importlib.import_module(COMMANDS[cmd][0]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
