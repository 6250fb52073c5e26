"""Visual conditioning evidence on the PyTorch port: a patients x noise
panel per checkpoint.

The counterpart of ``tools/conditioning_panel.py``, on ``rnagan_tpu_torch``
(it imports the port, numpy and the standard library only). It renders the
visible version of ``tools/representation_run_torch.py``'s experiment (the
comparison of reference ``generate_tissue_images.py:106-127``):

* rows are patients; the first column is that patient's first held-out real
  tile;
* the other ``--noise_cols`` columns are RNA-GAN tiles drawn in population
  mode with one shared noise seed (77, the JAX tool's key) for every row,
  so within a column the only input that varies is the patient's z.

A conditioning generator gives rows that differ; an unconditional-critic
generator gives columns that dominate. One panel per ``--arms`` entry
(``<checkpoint basename>:<critic>``), written as
``<out>/<name>_patient_panel.png``: the JAX tool writes a ``.jpg``, but the
port's ``utils/images.py::save_image_grid`` writes PNG with the standard
library and the card's machine has no JPEG encoder.

``--device`` replaces ``--platform``: the default is ``cuda`` here as in
every port entry point (the JAX tool defaults to the CPU), and the CPU runs
only when asked. ``--smoke`` (tiny shapes) is new.

Usage:
  python tools/conditioning_panel_torch.py --workdir runs/q_ab --out docs/quality/grids
  python tools/conditioning_panel_torch.py --smoke --device cpu --workdir <dir> --out <dir>
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the seed of the shared noise columns (the JAX tool's key 77, as the z-sensitivity diagnostic's)
PANEL_SEED = 77


def build_parser():
    p = argparse.ArgumentParser(description="patients x shared-noise panel per checkpoint")
    p.add_argument("--workdir", default="runs/q_ab")
    p.add_argument("--slides", type=int, default=100)
    p.add_argument("--tiles_per_slide", type=int, default=300)
    p.add_argument("--genes", type=int, default=19198)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--patients", type=int, default=6)
    p.add_argument("--noise_cols", type=int, default=5)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--arms", default="wganvae_proj:projection,wganvae:unconditional",
                   help="comma list of <ckpt_basename>:<critic> panels to render")
    p.add_argument("--out", default="docs/quality/grids")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.genes, args.size = 6, 12, 64, 32
        args.patients, args.noise_cols = 4, 3
    return args


def to_uint8(images01) -> np.ndarray:
    """[0, 1] floats -> uint8 (round half to even, as the JAX tool's ``np.round``)."""
    x = np.asarray(torch.as_tensor(images01).float().cpu())
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def main(argv=None):
    """Writes one panel per arm; returns ``{arm name: panel path}``."""
    args = parse_args(argv)
    from quality_run_torch import build_corpus, normalized_expression
    from representation_run_torch import gan_configs, load_vae, pick_ckpt

    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.eval.generate import generate_images
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer
    from rnagan_tpu_torch.utils.images import save_image_grid

    dev = resolve_device(args.device)
    corpus = build_corpus(args, dev)
    expr_norm, _ = normalized_expression(corpus)
    vae_sd, vae_cfg = load_vae(args)

    def real_tile(i: int) -> np.ndarray:  # the slide's first held-out tile, uint8
        img = corpus.render([i], [corpus.tiles_per_slide])  # [-1, 1]
        return to_uint8(img * 0.5 + 0.5)[0]

    paths = {}
    for arm in args.arms.split(","):
        name, critic = arm.split(":")
        cfg, _ = gan_configs(args, vae_cfg, critic)
        trainer = GANTrainer(cfg, vae_sd, device=dev)
        state = trainer.load_model(pick_ckpt(args.workdir, name))
        trainer.set_z_population(expr_norm)
        rows = []
        for i in range(args.patients):
            fakes = generate_images(trainer, state, args.noise_cols, PANEL_SEED, gene=expr_norm[i],
                                    condition_mode="population")
            rows.append(np.concatenate([real_tile(i)[None], to_uint8(fakes)], axis=0))
        path = os.path.join(args.out, f"{name}_patient_panel.png")
        save_image_grid(np.concatenate(rows, axis=0), path, nrow=args.noise_cols + 1)
        paths[name] = path
        print(f"[panel] {path}: {args.patients} patients x (1 real + {args.noise_cols} shared-noise fakes), "
              f"critic={critic}", flush=True)
        del trainer, state
    return paths


if __name__ == "__main__":
    main()
