"""Conditional tile synthesis CLI (port of ``rnagan_tpu/cli/generate.py``, the
reference ``src/generate_tissue_images.py`` surface, ``--device`` in place of
``--platform``):

    python -m rnagan_tpu_torch.cli.generate --config CFG --checkpoint GAN.model \\
        --vae VAE.ckpt --rna_file expr.csv --random_patient --sample_size 64 \\
        --save_path out.png
    # or a per-patient comparison:
    ... --checkpoint RNA_GAN.model --checkpoint2 GAN.model --patient GTEX-XXX --save_dir out/

``--checkpoint``/``--checkpoint2`` take a torchgan ``.model`` or a JAX
bundle, ``--vae`` a betaVAE ``.pt`` or a JAX ``model_best.ckpt``. Seeds
take the place of the JAX package's keys.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Generate tissue tiles from a trained GAN / RNA-GAN")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True, help="RNA-GAN .model bundle")
    p.add_argument("--checkpoint2", type=str, default=None, help="unconditional GAN bundle for comparison")
    p.add_argument("--vae", type=str, default=None,
                   help="beta-VAE checkpoint (required for RNA-GAN/wganvae bundles; "
                        "omit to sample a plain-GAN checkpoint unconditionally)")
    p.add_argument("--rna_file", type=str, default=None, help="CSV with rna_ columns (e.g. GEO data)")
    p.add_argument("--random_patient", action="store_true", help="sample one row from --rna_file")
    p.add_argument("--patient", type=str, default=None, help="wsi_file_name to condition on")
    p.add_argument("--gan_type", type=str, default=None,
                   help="architecture of the checkpoint (dcgan | dcgan_up | condgan | sagan | "
                        "biggan); defaults to the config's gan_type key or dcgan")
    p.add_argument("--sample_size", type=int, default=64)
    p.add_argument("--save_path", type=str, default="generated.png")
    p.add_argument("--save_dir", type=str, default="generated")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--condition_mode", choices=["reference", "population"], default="reference",
                   help="reference = exact parity (batch standardization cancels a single "
                        "patient's z); population = conditioning-preserving")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def _load_trainer(cfg_json, ckpt, vae_path, args):
    """A ``GANTrainer`` for the config's architecture (wganvae with ``vae_path``,
    else wgan) and the state of ``ckpt``."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    arch = getattr(args, "gan_type", None) or cfg_json.get("gan_type", "dcgan")
    if arch == "biggan_pub":
        raise SystemExit("arch 'biggan_pub' (the published BigGAN) trains through gan-train only: "
                         "generate and the tools that load a generator through it do not serve it")
    num_classes = len(cfg_json.get("path_csv", ())) if arch in ("condgan", "biggan") else 0
    model_cfg = GANModelConfig(
        arch=arch,
        out_size=int(cfg_json.get("img_size", 256)),
        encoding_dims=int(cfg_json.get("encoding_dims", 2048)),
        step_channels=int(cfg_json.get("step_channels", 32 if arch in ("condgan", "sagan") else 64)),
        num_classes=num_classes,
        attn_size=int(cfg_json.get("attn_size", 32)),
        compute_dtype=str(cfg_json.get("compute_dtype", "bfloat16")),
    )
    cfg = GANConfig(
        model=model_cfg,
        loss_type="wganvae" if vae_path else "wgan",
        vae=VAEModelConfig(
            rna_features=int(cfg_json.get("rna_features", 19198)),
            z_dim=int(cfg_json.get("z_dim", 2048)),
            encoder_dims=tuple(cfg_json.get("encoder_dims", (6000, 4000, 2048))),
            decoder_dims=tuple(cfg_json.get("decoder_dims", (4000, 6000))),
        ),
        vae_checkpoint=vae_path,
        seed=args.seed,
    )
    trainer = GANTrainer(cfg, device=args.device)
    return trainer, trainer.load_model(ckpt)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.core.config import load_reference_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.rna import RNATable, Scaler, log_transform
    from rnagan_tpu_torch.eval.generate import compare_real_vs_synthetic, generate_patient_grid
    from rnagan_tpu_torch.losses.rna_infusion import z_population_stats
    from rnagan_tpu_torch.utils.images import save_image_grid

    resolve_device(args.device)
    cfg_json = load_reference_json(args.config)
    trainer, state = _load_trainer(cfg_json, args.checkpoint, args.vae, args)

    gene, z_pop = None, None
    if args.rna_file:
        table = RNATable.read_csv(args.rna_file)
        vals = log_transform(table.values)
        normed = Scaler.fit(vals, "standard").transform(vals)
        if args.random_patient:
            row = np.random.RandomState(args.seed).randint(len(normed))
        elif args.patient is not None:
            row = int(np.flatnonzero(table.wsi_file_name == args.patient)[0])
        else:
            row = 0
        gene = normed[row:row + 1]
        if args.condition_mode == "population":
            # the statistics bundled at training time, else the CSV's
            z_pop = trainer.z_pop if trainer.z_pop is not None else z_population_stats(trainer.vae, normed)

    if z_pop is not None:
        imgs = trainer.sample(state, args.sample_size, gene=gene, z_pop=z_pop, seed=args.seed) * 0.5 + 0.5
        save_image_grid(imgs * 2 - 1, args.save_path, nrow=8)
    else:
        imgs = generate_patient_grid(trainer, state, gene, args.seed, args.save_path,
                                     sample_size=args.sample_size)
    print(f"wrote {args.save_path} ({imgs.shape[0]} tiles)")

    if args.checkpoint2:
        gan_trainer, gan_state = _load_trainer(cfg_json, args.checkpoint2, None, args)
        # no real tiles in this mode: the synthetic pair is compared
        real = np.zeros((args.sample_size, *imgs.shape[1:]), np.float32)
        compare_real_vs_synthetic(trainer, state, gan_trainer, gan_state, real, gene, args.seed + 1,
                                  args.save_dir, sample_size=args.sample_size)
        print(f"wrote comparison grids to {args.save_dir}")
    return imgs


if __name__ == "__main__":
    main()
