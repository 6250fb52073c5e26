"""FID evaluation CLI (port of ``rnagan_tpu/cli/fid.py``, the reference
``src/fid.py:235-330`` surface, ``--device`` in place of ``--platform``):

* real-vs-fake (default): dataset tiles (or ``--patient1``'s own tiles)
  against a checkpoint's samples, ``--repetitions`` generations, mean and std;
* fake-vs-fake (``--checkpoint2``): both checkpoints sampled anew each
  repetition, the second unconditionally (reference ``fid.py:321``);
* real-vs-real (``--patient1 --patient2 --real``): two patients' real tiles,
  the second optionally from ``--config2``'s dataset, computed once (std 0).

    python -m rnagan_tpu_torch.cli.fid --config CFG --checkpoint GAN.model \\
        [--vae VAE.ckpt --patient1 GTEX-XXX] [--checkpoint2 GAN2.model] \\
        [--patient2 GTEX-YYY --real [--config2 CFG2]] [--inception_weights W]

Without ``--inception_weights`` the features come from the seeded init: the
pipeline is exercised, and the number is not comparable with published FIDs.
Repetition r samples with seed ``seed + r`` (the second checkpoint
``seed + 1 + r``).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="FID between tile sets (real and/or generated)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--config2", type=str, default=None,
                   help="second dataset config for --patient2 (reference fid.py:296-301)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="GAN checkpoint (required unless --real patient-vs-patient mode)")
    p.add_argument("--checkpoint2", type=str, default=None, help="second GAN checkpoint: fake-vs-fake")
    p.add_argument("--vae", type=str, default=None)
    p.add_argument("--patient1", type=str, default=None, help="condition on this patient")
    p.add_argument("--patient2", type=str, default=None)
    p.add_argument("--real", action="store_true", default=False,
                   help="with --patient1/--patient2: compare the two patients' real tiles")
    p.add_argument("--num_images", type=int, default=600)
    p.add_argument("--repetitions", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_patches", type=int, default=200)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="pretrained InceptionV3 weights (.pt/.pth torchvision state_dict, "
                        ".npz/.h5 keras); without them the features come from a seeded "
                        "init (pipeline-valid, NOT comparable to published FID numbers)")
    p.add_argument("--gan_type", type=str, default=None,
                   help="architecture of the checkpoint(s); defaults to the config key or dcgan")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def _patient_real(cfg_json, patient, num_images, seed, with_rna):
    from rnagan_tpu_torch.cli.common import load_gan_dataframe
    from rnagan_tpu_torch.data.patches import patient_tiles
    from rnagan_tpu_torch.data.rna import Scaler, log_transform

    slides = load_gan_dataframe(cfg_json)
    if with_rna:
        vals = log_transform(slides.rna.values)
        slides = slides.with_rna_values(Scaler.fit(vals, "standard").transform(vals))
    tiles, rna = patient_tiles(slides, patient, num_images, seed=seed)
    return tiles.astype(np.float32) / 255.0, rna


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.cli.common import load_gan_dataframe, load_inception_extractor
    from rnagan_tpu_torch.cli.generate import _load_trainer
    from rnagan_tpu_torch.core.config import load_reference_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.patches import load_patch_data
    from rnagan_tpu_torch.eval.fid import (calculate_activation_statistics, calculate_frechet_distance,
                                           fid_repetitions)
    from rnagan_tpu_torch.eval.generate import generate_images

    device = resolve_device(args.device)
    cfg_json = load_reference_json(args.config)
    extractor = load_inception_extractor(args.inception_weights, device=device)

    # ---- real-vs-real: two patients' tiles, no generation
    if args.real and args.patient1 and args.patient2:
        real1, _ = _patient_real(cfg_json, args.patient1, args.num_images, args.seed, args.vae)
        cfg2 = load_reference_json(args.config2) if args.config2 else cfg_json
        real2, _ = _patient_real(cfg2, args.patient2, args.num_images, args.seed, args.vae)
        print(f"real sets: {len(real1)} vs {len(real2)} tiles")
        mu1, s1 = calculate_activation_statistics(real1, args.batch_size, extractor)
        mu2, s2 = calculate_activation_statistics(real2, args.batch_size, extractor)
        fid = calculate_frechet_distance(mu1, s1, mu2, s2)
        print(f"FID: {fid:.4f} +/- 0.0000  (real-vs-real is deterministic)")
        return fid, 0.0

    if not args.checkpoint:
        raise SystemExit("--checkpoint is required except in --real patient-vs-patient mode")
    trainer, state = _load_trainer(cfg_json, args.checkpoint, args.vae, args)

    gene, real01 = None, None
    if args.patient1:
        real01, rna = _patient_real(cfg_json, args.patient1, args.num_images, args.seed, args.vae)
        gene = rna if args.vae else None
    elif not args.checkpoint2:
        # fake-vs-fake never reads the real set: no LMDB decode then
        data = load_patch_data(load_gan_dataframe(cfg_json), max_patches_total=args.num_patches,
                               seed=args.seed)
        real01 = data.images[:args.num_images].astype(np.float32) / 255.0

    def gen(rep):
        return generate_images(trainer, state, args.num_images, args.seed + rep, gene=gene)

    # ---- fake-vs-fake: both sides sampled anew each repetition
    if args.checkpoint2:
        trainer2, state2 = _load_trainer(cfg_json, args.checkpoint2, None, args)
        fids = []
        for rep in range(args.repetitions):
            mu1, s1 = calculate_activation_statistics(gen(rep), args.batch_size, extractor)
            fake2 = generate_images(trainer2, state2, args.num_images, args.seed + 1 + rep)
            mu2, s2 = calculate_activation_statistics(fake2, args.batch_size, extractor)
            fids.append(calculate_frechet_distance(mu1, s1, mu2, s2))
        mean, std = float(np.mean(fids)), float(np.std(fids))
        print(f"FID: {mean:.4f} +/- {std:.4f}  (reps: {[round(f, 4) for f in fids]})")
        return mean, std

    # ---- real-vs-fake (default)
    print(f"real set: {len(real01)} tiles")
    mean, std, fids = fid_repetitions(real01, gen, n_reps=args.repetitions, batch_size=args.batch_size,
                                      extractor=extractor)
    print(f"FID: {mean:.4f} +/- {std:.4f}  (reps: {[round(f, 4) for f in fids]})")
    return mean, std


if __name__ == "__main__":
    main()
