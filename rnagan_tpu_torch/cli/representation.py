"""Per-patient representation CLI (port of ``rnagan_tpu/cli/representation.py``,
the reference ``src/compute_representation.py`` surface, ``--device`` in
place of ``--platform``): mean Inception activations of real, RNA-GAN and
GAN tiles per patient, saved as ``.npy`` matrices.

    python -m rnagan_tpu_torch.cli.representation --config CFG \\
        --checkpoint RNA_GAN.model --checkpoint2 GAN.model --vae VAE.ckpt \\
        [--gan_type sagan] [--condition_mode population] --save_dir representations/

The checkpoints are torchgan ``.model`` or JAX bundles of any ``--gan_type``;
``--vae`` a betaVAE ``.pt`` or a JAX ``model_best.ckpt``. Patient i's tiles
take seeds ``seed + 2i`` (RNA-GAN) and ``seed + 2i + 1`` (GAN), where the JAX
CLI folds i into a key. Without ``--inception_weights`` the features come
from the seeded init: not comparable with the reference's numbers.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Per-patient representation analysis")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True, help="RNA-GAN bundle")
    p.add_argument("--checkpoint2", type=str, required=True, help="unconditional GAN bundle")
    p.add_argument("--vae", type=str, required=True)
    p.add_argument("--tiles_per_patient", type=int, default=64)
    p.add_argument("--max_patients", type=int, default=None)
    p.add_argument("--num_patches", type=int, default=64)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--condition_mode", choices=["reference", "population"], default="reference",
                   help="RNA-GAN generation infusion: reference = the reference's per-batch "
                        "standardization (cancels a single patient's z); population = "
                        "conditioning-preserving (z-population statistics)")
    p.add_argument("--save_dir", type=str, default="representations")
    p.add_argument("--gan_type", type=str, default=None,
                   help="architecture of the checkpoint(s); defaults to the config key or dcgan")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.cli.common import load_gan_dataframe, load_inception_extractor
    from rnagan_tpu_torch.cli.generate import _load_trainer
    from rnagan_tpu_torch.core.config import load_reference_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.patches import load_patch_data
    from rnagan_tpu_torch.data.rna import Scaler, log_transform
    from rnagan_tpu_torch.eval.representation import compute_representations

    device = resolve_device(args.device)  # before anything is read
    cfg_json = load_reference_json(args.config)
    rna_trainer, rna_state = _load_trainer(cfg_json, args.checkpoint, args.vae, args)
    gan_trainer, gan_state = _load_trainer(cfg_json, args.checkpoint2, None, args)

    slides = load_gan_dataframe(cfg_json)
    vals = log_transform(slides.rna.values)
    slides = slides.with_rna_values(Scaler.fit(vals, "standard").transform(vals))
    data = load_patch_data(slides, max_patches_total=args.num_patches, seed=args.seed, with_rna=True)
    patients = data.slides[: args.max_patients] if args.max_patients else data.slides

    def real_tiles(patient):
        sid = data.slides.index(patient)
        return data.images[data.slide_idx == sid][: args.tiles_per_patient].astype(np.float32) / 255.0

    def gene(patient):
        return data.rna[data.slides.index(patient)][None, :]

    if args.condition_mode == "population" and rna_trainer.z_pop is None:
        # the checkpoint bundles no z-population statistics: take the run's own
        rna_trainer.set_z_population(data.rna)

    reps = compute_representations(
        patients, real_tiles, gene, rna_trainer, rna_state, gan_trainer, gan_state, seed=args.seed,
        tiles_per_patient=args.tiles_per_patient,
        extractor=load_inception_extractor(args.inception_weights, device=device),
        save_dir=args.save_dir, condition_mode=args.condition_mode)
    print(f"wrote {args.save_dir}/representations_{{real,rnagan,gan}}.npy "
          f"({len(patients)} patients x 2048)")
    return reps


if __name__ == "__main__":
    main()
