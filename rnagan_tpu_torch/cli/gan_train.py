"""GAN / RNA-GAN training CLI (port of ``rnagan_tpu/cli/gan_train.py``, the flag
surface of reference ``src/histopathology_gan.py:54-72``, ``--device`` in
place of ``--platform``):

    python -m rnagan_tpu_torch.cli.gan_train --config configs/gan_run.json \\
        --image_dir images --model_dir checkpoints/gan --num_epochs 24 \\
        --num_patches 600 --gan_type dcgan --loss_type wganvae \\
        --vae_checkpoint model_best.ckpt [--fid_every 1] [--device cuda]

The slide table of the config (``cli/common.py::load_gan_dataframe``) ->
for wganvae, log + standard scaling of the expression over all rows ->
``load_patch_data`` (the LMDB tile stores) -> ``GANTrainer.fit`` on
``PatchBatches``. ``--vae_checkpoint`` takes a betaVAE ``.pt`` or a JAX
``model_best.ckpt``; ``--checkpoint`` a torchgan ``.model`` or a JAX
``gan_last.model``. ``--fid_every N`` probes FID every N epochs through
InceptionV3 (seeded weights unless ``--inception_weights``; such an FID is
not comparable with published ones) against ``--fid_images`` real tiles and
keeps ``gan_best.model`` at the lowest. Returns ``fit``'s results with the
data load's tiles, slides and seconds under ``"data"``.

Data-parallel on several cards through torchrun (one rank a card, NCCL; the
batch is the global batch, padded to a multiple of the ranks)::

    torchrun --nproc_per_node 4 -m rnagan_tpu_torch.cli.gan_train --config ... \
        [--dist_backend nccl]
"""

from __future__ import annotations

import argparse
import time

from rnagan_tpu_torch.cli.common import add_dist_arguments, training_mesh


def build_parser():
    p = argparse.ArgumentParser(description="GANs training on histology data")
    p.add_argument("--config", type=str, required=True, help="JSON config file")
    p.add_argument("--checkpoint", type=str, default=None, help="checkpoint to resume from")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--image_dir", type=str, default="images")
    p.add_argument("--model_dir", type=str, default="./model/gan")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--num_patches", type=int, default=250, help="tiles per slide")
    p.add_argument("--gan_type", type=str, default="dcgan",
                   help="dcgan | dcgan_up | condgan | sagan | biggan | biggan_pub (biggan and biggan_pub, "
                        "the published BigGAN, are class-conditional over the config's CSVs)")
    p.add_argument("--loss_type", type=str, default="wganvae", help="minimax | wgan | wganvae | lsgan")
    p.add_argument("--vae_checkpoint", type=str, default=None,
                   help="beta-VAE checkpoint for wganvae: a .pt state_dict or a JAX bundle")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--critic", type=str, default="unconditional", choices=["unconditional", "projection"],
                   help="projection = condition the critic on the frozen VAE embedding "
                        "(wganvae, dcgan family only)")
    p.add_argument("--n_critic", type=int, default=1,
                   help="critic steps per G update (WGAN schedule; 1 = reference parity)")
    p.add_argument("--no_clip", action="store_true", help="disable the wgan +-0.01 weight clip")
    p.add_argument("--compat_reference_gp", action="store_true",
                   help="reproduce the reference's two-step GP dynamics exactly")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from model_dir/gan_last.model when present")
    p.add_argument("--fid_every", type=int, default=0,
                   help="an FID probe every N epochs, logged into the epoch metrics")
    p.add_argument("--fid_images", type=int, default=128)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--g_ema_decay", type=float, default=None,
                   help="EMA decay of the generator weights; sampling and the FID probe use the EMA")
    p.add_argument("--adam_mu_dtype", type=str, default=None, choices=("bfloat16", "float32"),
                   help="dtype of Adam's first moment (default float32)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    add_dist_arguments(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from rnagan_tpu_torch.cli.common import load_gan_dataframe
    from rnagan_tpu_torch.core.config import (GANConfig, GANModelConfig, MeshConfig, VAEModelConfig,
                                              load_reference_json)
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.patches import PatchBatches, load_patch_data
    from rnagan_tpu_torch.data.rna import Scaler, log_transform
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    resolve_device(args.device)  # before any data is read
    mesh = training_mesh(args, MeshConfig())
    device = mesh.device
    config = load_reference_json(args.config)
    print("-" * 10)
    print("Config for this experiment\n")
    print(config)
    print("-" * 10)

    slides = load_gan_dataframe(config)
    with_rna = args.loss_type == "wganvae"
    if with_rna:
        # log + standardize the rna_ columns over all rows (reference histopathology_gan.py:131-151)
        vals = log_transform(slides.rna.values)
        slides = slides.with_rna_values(Scaler.fit(vals, "standard").transform(vals))

    t0 = time.perf_counter()
    data = load_patch_data(slides, max_patches_total=args.num_patches, seed=args.seed,
                           quick=bool(config.get("quick", False)), with_rna=with_rna)
    load_s = time.perf_counter() - t0
    print(f"Loaded {len(data)} tiles from {len(data.slides)} slides in {load_s:.3f} s")

    # condgan and the BigGANs are class-conditional over the tissue CSVs (the reference's
    # biggan wiring's n_classes=2 is its 2 CSVs); sagan is unconditional
    conditional = args.gan_type in ("condgan", "biggan", "biggan_pub")
    published = args.gan_type == "biggan_pub"  # attention at 64x64 and a 128-wide shared embedding
    model_cfg = GANModelConfig(
        arch=args.gan_type,
        out_size=int(config.get("img_size", 256)),
        encoding_dims=int(config.get("encoding_dims", 2048)),
        step_channels=int(config.get("step_channels", 32 if args.gan_type in ("condgan", "sagan") else 64)),
        num_classes=len(config["path_csv"]) if conditional else 0,
        attn_size=int(config.get("attn_size", 64 if published else 32)),
        **({"embed_dim": int(config.get("embed_dim", 128))} if published else {}),
        critic=args.critic,
        compute_dtype=str(config.get("compute_dtype", "bfloat16")),
    )
    vae_model = VAEModelConfig(
        rna_features=int(config.get("rna_features", 19198)),
        z_dim=int(config.get("z_dim", 2048)),
        encoder_dims=tuple(config.get("encoder_dims", (6000, 4000, 2048))),
        decoder_dims=tuple(config.get("decoder_dims", (4000, 6000))),
    )
    cfg = GANConfig(
        model=model_cfg, loss_type=args.loss_type, batch_size=args.batch_size,
        num_epochs=args.num_epochs or int(config.get("num_epochs", 900)), vae=vae_model,
        vae_checkpoint=args.vae_checkpoint or config.get("encoder_checkpoint"),
        compat_reference_gp=args.compat_reference_gp, n_critic=args.n_critic,
        adam_mu_dtype=args.adam_mu_dtype, g_ema_decay=args.g_ema_decay,
        **({"clip": None} if args.no_clip else {}), seed=args.seed,
    )
    trainer = GANTrainer(cfg, image_dir=args.image_dir, model_dir=args.model_dir, mesh=mesh)
    if with_rna and data.rna is not None and len(data.rna):
        trainer.set_z_population(data.rna)  # bundled for conditioning-preserving generation
    state = trainer.load_model(args.checkpoint) if args.checkpoint else None

    eval_fn = None
    if args.fid_every:
        import torch

        from rnagan_tpu_torch.cli.common import load_inception_extractor
        from rnagan_tpu_torch.eval.fid import calculate_fid
        from rnagan_tpu_torch.eval.generate import generate_images

        extractor = load_inception_extractor(args.inception_weights, device=device)
        # the tiles are concatenated slide by slide: a head slice would be one slide
        pick = np.random.RandomState(args.seed).choice(
            len(data.images), min(args.fid_images, len(data.images)), replace=False)
        real01 = torch.from_numpy(data.images[pick]).to(device).float() / 255.0

        def eval_fn(epoch, st, tr):
            fake = generate_images(tr, st, args.fid_images, seed=epoch)
            # batches of 32, as the JAX probe runs (a smaller set needs no padding to 32)
            return {"fid": calculate_fid(real01, fake, batch_size=min(32, len(real01)), extractor=extractor)}

    batches = PatchBatches(data, batch_size=cfg.batch_size, with_rna=with_rna,
                           with_labels=conditional, seed=args.seed, pad_to=mesh.data)
    state, results = trainer.fit(lambda e: batches.epoch(e), state=state, auto_resume=args.auto_resume,
                                 eval_fn=eval_fn, eval_every=args.fid_every,
                                 keep_best_metric="fid" if eval_fn else None)
    print("Final epoch:", results["history"][-1] if results["history"] else {})
    results["data"] = {"tiles": len(data), "slides": len(data.slides), "load_s": load_s}
    return results


if __name__ == "__main__":
    main()
