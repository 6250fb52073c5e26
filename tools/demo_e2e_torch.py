"""End-to-end demo of the PyTorch port on synthetic data (no downloads).

The counterpart of ``tools/demo_e2e.py``, on ``rnagan_tpu_torch`` (it imports
the port, numpy, the standard library and PIL only). It walks the reference
workflow (``docs/WORKFLOWS.md``) in miniature, through the port's CLIs and
``cli.main``, at the JAX demo's sizes and in its order:

  1. synthesize H&E-like slides (PNG) + GTEx-layout expression CSVs (``csv``)
  2. ``tile`` the slides into reference-format LMDB databases (native store)
  3. ``betavae-train``: the beta-VAE, its scaler bundled
  4. ``gan-train``: RNA-GAN (wganvae) on the tiles, conditioned on the VAE
  5. ``generate``: patient-conditioned tiles in both condition modes
  6. ``fid``: real against synthetic, 2 repetitions
  7. ``interpolate`` + ``sample``: latent interpolation, expression sampling
  8. downstream tile classification (2-fold CV, a one-block ResNet)

Step 1 writes the slides with PIL and ``tile`` reads them through PIL
(``rnagan_tpu_torch/data/tiler.py``): on a machine without PIL the demo
stops at step 1 and names it. ``--device`` (default ``cuda``) replaces the
JAX demo's platform pick; the CPU runs only when asked. The VAE checkpoint
is the port's ``model_dict_best.pt`` where the JAX demo reads
``model_best.ckpt``.

Usage:
  python tools/demo_e2e_torch.py [workdir] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

GENES = 24


def build_parser():
    p = argparse.ArgumentParser(description="the reference workflow in miniature through the port's CLIs")
    p.add_argument("workdir", nargs="?", default="/tmp/rnagan_demo")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def write_slides_and_csvs(rng: np.random.RandomState):
    """Step 1: 2 tissues x 4 slides of 384x512 blobs as ``wsi/*.png`` and one
    expression CSV a tissue; returns the CSV paths."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("demo_e2e_torch step 1 needs PIL: it writes the slides as PNG, and `tile` "
                           "reads them through PIL") from e
    os.makedirs("wsi", exist_ok=True)
    csvs = []
    yy, xx = np.mgrid[0:384, 0:512]
    for t in range(2):
        rows = []
        for i in range(4):
            name = f"GTEX-T{t}-{i:04d}"
            img = np.full((384, 512, 3), 245, np.uint8)
            for _ in range(6):
                cx, cy, r = rng.randint(0, 512), rng.randint(0, 384), rng.randint(60, 120)
                blob = (xx - cx) ** 2 + (yy - cy) ** 2 < r**2
                img[blob] = np.stack(
                    [rng.randint(150, 220, blob.sum()), rng.randint(60, 120, blob.sum()),
                     rng.randint(140, 200, blob.sum())], -1).astype(np.uint8)
            Image.fromarray(img).save(f"wsi/{name}.png")
            expr = rng.gamma(2.0, 30.0, GENES)
            expr[rng.rand(GENES) < 0.2] = 0
            rows.append([name, *(repr(float(v)) for v in expr)])
        path = f"tissue{t}.csv"
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["wsi_file_name", *(f"rna_ENSG{g:04d}" for g in range(GENES))])
            writer.writerows(rows)
        csvs.append(path)
    return csvs


def main(argv=None):
    """Runs the 8 steps in ``workdir``; returns what each produced."""
    args = build_parser().parse_args(argv)
    from rnagan_tpu_torch.core.device import resolve_device

    dev = str(resolve_device(args.device))
    os.makedirs(args.workdir, exist_ok=True)
    out = {}
    with contextlib.chdir(args.workdir):
        rng = np.random.RandomState(0)
        print("== 1. synthesizing slides + expression CSVs")
        csvs = write_slides_and_csvs(rng)

        from rnagan_tpu_torch.cli import main as cli

        print("== 2. tiling slides (native LMDB/LZ4 store)")
        cli.main(["tile", "--wsi_path", "wsi", "--patch_path", "tiles", "--mask_path", "masks",
                  "--patch_size", "32", "--max_patches_per_slide", "24"])

        print("== 3. training the beta-VAE")
        with open("vae.json", "w") as f:
            json.dump({"path_csv": csvs, "rna_features": GENES, "z_dim": 16, "encoder_dims": [24, 16],
                       "decoder_dims": [24], "lr": 1e-3, "weights_decay": 0, "num_epochs": 3, "batch_size": 8,
                       "beta": 5e-4, "optimizer": "Adam", "log_interval": 10, "save_dir": "vae_ckpt",
                       "summary_path": "sums"}, f)
        from rnagan_tpu_torch.cli import betavae_train

        out["vae"] = betavae_train.main(["--config", "vae.json", "--device", dev])
        print(f"   best epoch {out['vae']['best_epoch']}")
        vae_ckpt = "vae_ckpt/model_dict_best.pt"

        print("== 4. training RNA-GAN (wganvae)")
        with open("gan.json", "w") as f:
            json.dump({"path_csv": csvs, "patch_data_path": ["tiles", "tiles"], "img_size": 32,
                       "encoding_dims": 16, "step_channels": 8, "compute_dtype": "float32",
                       "rna_features": GENES, "z_dim": 16, "encoder_dims": [24, 16], "decoder_dims": [24],
                       "max_patch_per_wsi": 24, "num_epochs": 2}, f)
        from rnagan_tpu_torch.cli import gan_train

        out["gan"] = gan_train.main([
            "--config", "gan.json", "--image_dir", "images", "--model_dir", "gan_ckpt", "--num_epochs", "2",
            "--num_patches", "24", "--gan_type", "dcgan", "--loss_type", "wganvae", "--vae_checkpoint", vae_ckpt,
            "--batch_size", "16", "--device", dev])
        print("   last epoch: " + " ".join(f"{k}={v:.3f}" for k, v in out["gan"]["history"][-1].items()
                                           if k in ("d_loss", "g_loss", "gp")))

        print("== 5. generating patient-conditioned tiles")
        for mode in ("reference", "population"):
            cli.main(["generate", "--config", "gan.json", "--checkpoint", "gan_ckpt/gan_last.model",
                      "--vae", vae_ckpt, "--rna_file", csvs[0], "--random_patient", "--sample_size", "16",
                      "--condition_mode", mode, "--save_path", f"generated_{mode}.png", "--device", dev])
        print("   wrote generated_reference.png / generated_population.png")

        print("== 6. FID (real vs synthetic, 2 repetitions)")
        from rnagan_tpu_torch.cli import fid

        out["fid"] = fid.main(["--config", "gan.json", "--checkpoint", "gan_ckpt/gan_last.model", "--vae", vae_ckpt,
                               "--num_images", "16", "--repetitions", "2", "--batch_size", "8",
                               "--num_patches", "16", "--device", dev])

        print("== 7. latent interpolation + expression sampling")
        cli.main(["interpolate", "--config", "vae.json", "--checkpoint", vae_ckpt, "--save_path", "interp.pkl",
                  "--device", dev])
        cli.main(["sample", "--config", "vae.json", "--checkpoint", vae_ckpt, "--num_samples", "5",
                  "--interpolation", "interp.pkl", "--save_path", "expr.pkl", "--device", dev])

        print("== 8. downstream tile classification (2-fold CV)")
        from functools import partial

        from rnagan_tpu_torch.cli.common import load_gan_dataframe
        from rnagan_tpu_torch.core.config import MLConfig
        from rnagan_tpu_torch.data.patches import load_patch_data
        from rnagan_tpu_torch.models.resnet import BasicBlock, ResNet
        from rnagan_tpu_torch.train.ml_experiment import run_cv_experiment

        data = load_patch_data(load_gan_dataframe({"path_csv": csvs, "patch_data_path": ["tiles", "tiles"]}),
                               max_patches_total=12)
        cfg = MLConfig(num_epochs=1, folds=2, batch_size=16, image_size=32)
        tiny = partial(ResNet, BasicBlock, (1, 1, 1, 1), num_classes=2, compute_dtype="float32")
        out["cv"] = run_cv_experiment(data.images.astype(np.float32) / 255.0, data.labels.astype(np.int64), cfg,
                                      model=tiny, device=dev)
        print(f"   CV accuracy {out['cv']['mean_accuracy']:.3f}")
    print("\nDEMO COMPLETE:", args.workdir)
    return out


if __name__ == "__main__":
    main()
