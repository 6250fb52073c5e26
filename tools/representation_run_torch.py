"""The conditioning proof on the PyTorch port: per-patient representations
of real, RNA-GAN and GAN tiles on the procedural corpus.

The counterpart of ``tools/representation_run.py``, on ``rnagan_tpu_torch``
(it imports the port, numpy and the standard library only). The RNA-GAN's
point is that tiles generated from a patient's expression profile sit closer,
in Inception feature space, to that patient's real tiles than to other
patients'. This drives ``eval/representation.py::compute_representations``
(reference ``compute_representation.py:149-170``) with:

* real tiles: held-out renders per slide (never seen in training);
* RNA-GAN tiles: the ``--rna_name`` checkpoint conditioned on each patient;
* GAN tiles: the ``--gan_name`` checkpoint (the unconditional control);

then reports ``distance_statistics`` for both condition modes
(``population``, which keeps the patient's z, and ``reference``, whose
per-batch standardization cancels it), the real-vs-real ceiling on two
disjoint held-out halves, and the z-sensitivity diagnostic: pixel deltas
between patients under the same noise seed against the delta of a fresh
seed for one patient.

Inputs come from a run of ``tools/quality_run_torch.py`` in ``--workdir``:
``vae_pretrain.pt`` and ``{name}_best.model`` (or ``_last``). Outputs, with the
JAX tool's names and keys: ``<out>/distance_stats.json`` and the
``representations_{real,rnagan,gan}.npy`` files under ``<out>`` and
``<out>/reference_mode``.

``--device`` replaces ``--platform`` (default ``cuda``; the CPU only when
asked). A ``jax.random`` key becomes an integer seed: 1234 for the two
generation passes (``compute_representations`` gives patient i the seeds
1234 + 2i and 1234 + 2i + 1), 77 for the z-sensitivity draws and 78 for its
fresh-noise rerun (the JAX tool's ``fold_in(key(77), 1)``). ``--smoke``
(tiny shapes) is new: there a fixed linear map of 8x8 thumbnails stands in
for InceptionV3, which the CPU cannot run at test speed.

Usage:
  python tools/representation_run_torch.py --workdir runs/quality \\
      --out docs/quality/representations_torch
  python tools/representation_run_torch.py --smoke --device cpu --workdir <dir> --out <dir>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the seeds that stand for the JAX tool's keys
REPS_SEED, Z_SEED = 1234, 77


def build_parser():
    p = argparse.ArgumentParser(description="per-patient representation analysis on the procedural corpus")
    p.add_argument("--workdir", default="runs/quality",
                   help="quality-run output dir holding the checkpoints + VAE")
    p.add_argument("--slides", type=int, default=200)
    p.add_argument("--tiles_per_slide", type=int, default=600)
    p.add_argument("--genes", type=int, default=19198)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--patients", type=int, default=50,
                   help="number of corpus slides treated as patients")
    p.add_argument("--tiles_per_patient", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--gan_name", default="wgan",
                   help="checkpoint basename of the unconditional control arm")
    p.add_argument("--rna_name", default="wganvae",
                   help="checkpoint basename of the conditional arm (a quality_run --tag), e.g. wganvae_proj")
    p.add_argument("--critic", default="unconditional", choices=["unconditional", "projection"],
                   help="critic config the --rna_name checkpoint was trained with (its D must match to load)")
    p.add_argument("--out", default="docs/quality/representations")
    p.add_argument("--ceiling_only", action="store_true",
                   help="skip generation; compute the real-vs-real ceiling + the z-sensitivity diagnostic "
                        "and merge them into an existing <out>/distance_stats.json")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.genes, args.size = 6, 12, 64, 32
        args.patients, args.tiles_per_patient = 4, 8
    return args


def pick_ckpt(workdir: str, name: str) -> str:
    for suffix in ("best", "last"):
        path = os.path.join(workdir, f"{name}_{suffix}.model")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {name}_best/_last.model in {workdir}: run tools/quality_run_torch.py first")


def gan_configs(args, vae_cfg, critic="unconditional"):
    """``(rna_cfg, gan_cfg)``: the conditional wganvae arm with ``critic``
    and the unconditional wgan control, at ``args.size`` (the JAX tool's)."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig

    rna_cfg = GANConfig(model=GANModelConfig(out_size=args.size, encoding_dims=vae_cfg.z_dim, critic=critic),
                        loss_type="wganvae", vae=vae_cfg)
    gan_cfg = GANConfig(model=GANModelConfig(out_size=args.size), loss_type="wgan")
    return rna_cfg, gan_cfg


def load_vae(args):
    """``(state_dict, config)`` of ``<workdir>/vae_pretrain.pt``."""
    from quality_run_torch import vae_model_config

    from rnagan_tpu_torch.convert import load_betavae_state_dict

    return load_betavae_state_dict(os.path.join(args.workdir, "vae_pretrain.pt")), vae_model_config(args)


def heldout_ids(corpus, slide: int, offset: int, count: int):
    """``(slide ids, tile ids)`` of ``count`` held-out tiles of ``slide``:
    tile ids ``tiles_per_slide + (offset + i) % HELDOUT_SPAN`` (never trained
    on; the range the FID probe draws from)."""
    sl = np.full(count, slide, np.int64)
    ti = corpus.tiles_per_slide + (offset + np.arange(count, dtype=np.int64)) % corpus.HELDOUT_SPAN
    return sl, ti


def render_heldout(corpus, slide: int, offset: int, count: int) -> torch.Tensor:
    """The held-out tiles of :func:`heldout_ids`, [-1, 1] NHWC on the corpus's device."""
    return corpus.render(*heldout_ids(corpus, slide, offset, count))


def z_sensitivity(per_patient, rerun) -> dict:
    """The JAX tool's z-sensitivity record from the [0, 1] tiles of each
    patient under one shared noise seed (``per_patient``, a list) and the
    first patient's tiles under a fresh seed (``rerun``): the mean pixel
    delta across patients against the same patient's delta between seeds."""
    per_patient = [np.asarray(torch.as_tensor(x).cpu(), np.float32) for x in per_patient]
    rerun = np.asarray(torch.as_tensor(rerun).cpu(), np.float32)
    n_zp, n_zt = len(per_patient), len(rerun)
    cross = [float(np.mean(np.abs(per_patient[i] - per_patient[j])))
             for i in range(n_zp) for j in range(i + 1, n_zp)]
    noise_delta = float(np.mean(np.abs(per_patient[0] - rerun)))
    return {
        "cross_patient_pixel_delta_same_noise": round(float(np.mean(cross)), 5),
        "same_patient_pixel_delta_fresh_noise": round(noise_delta, 5),
        "ratio": round(float(np.mean(cross)) / max(noise_delta, 1e-12), 4),
        "patients": n_zp, "tiles": n_zt,
    }


class ThumbnailFeatures:
    """``--smoke``'s stand-in for InceptionV3: each [0, 1] NHWC image
    average-pooled to 8x8, flattened and mapped to 2048 features by a fixed
    seeded matrix. Called as an extractor: ``(images, batch_size) -> (N, 2048)``."""

    def __init__(self, device, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        self.weight = (torch.randn(8 * 8 * 3, 2048, generator=gen) / 8.0).to(device)

    def __call__(self, images, batch_size: int = 64) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.weight.device, torch.float32).permute(0, 3, 1, 2)
        thumbs = torch.nn.functional.adaptive_avg_pool2d(x, 8).permute(0, 2, 3, 1).reshape(len(x), -1)
        return thumbs @ self.weight


def make_extractor(args, device):
    """InceptionV3 features: trained weights from ``INCEPTION_WEIGHTS`` when
    set, else the seeded random init in float32 (the JAX tool's); with
    ``--smoke`` the :class:`ThumbnailFeatures` stand-in."""
    from rnagan_tpu_torch.eval.fid import InceptionExtractor

    if args.smoke:
        return ThumbnailFeatures(device)
    weights = os.environ.get("INCEPTION_WEIGHTS")
    if weights:  # trained-weights parity path (docs/FID_WEIGHTS_RUNBOOK.md)
        from rnagan_tpu_torch.cli.common import load_inception_extractor

        print(f"[features] trained InceptionV3 from {weights}", flush=True)
        return load_inception_extractor(weights, device=device)
    return InceptionExtractor(None, dtype="float32", seed=0, device=device)


def main(argv=None):
    args = parse_args(argv)
    from quality_run_torch import build_corpus, normalized_expression

    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.eval.generate import generate_images
    from rnagan_tpu_torch.eval.representation import (compute_representations, distance_statistics,
                                                      mean_activation)
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[setup] device {dev} ({kind})", flush=True)
    t0 = time.perf_counter()
    corpus = build_corpus(args, dev)
    expr_norm, _ = normalized_expression(corpus)
    print(f"[setup] corpus + normalization {time.perf_counter() - t0:.1f}s", flush=True)

    vae_sd, vae_cfg = load_vae(args)
    rna_cfg, gan_cfg = gan_configs(args, vae_cfg, args.critic)
    rna_trainer = GANTrainer(rna_cfg, vae_sd, device=dev)
    gan_trainer = GANTrainer(gan_cfg, device=dev)
    rna_path = pick_ckpt(args.workdir, args.rna_name)
    gan_path = pick_ckpt(args.workdir, args.gan_name)
    rna_state = rna_trainer.load_model(rna_path)
    gan_state = None if args.ceiling_only else gan_trainer.load_model(gan_path)
    print(f"[setup] GAN states: {rna_path}, {gan_path}", flush=True)

    patients = [f"slide{i:04d}" for i in range(args.patients)]
    pidx = {name: i for i, name in enumerate(patients)}

    def real_tiles_fn(patient: str) -> torch.Tensor:
        return render_heldout(corpus, pidx[patient], 0, args.tiles_per_patient)

    def gene_fn(patient: str) -> np.ndarray:
        return expr_norm[pidx[patient]]

    # conditioning-preserving generation standardizes with z statistics over
    # the training expression matrix (losses/rna_infusion.py::z_population_stats)
    rna_trainer.set_z_population(expr_norm)
    extractor = make_extractor(args, dev)
    tissue = corpus.slides.tissue.cpu().numpy()[:args.patients]
    stats_path = os.path.join(args.out, "distance_stats.json")

    if args.ceiling_only:
        with open(stats_path) as f:
            result = json.load(f)  # merge into the existing full run
    else:
        t0 = time.perf_counter()
        reps = compute_representations(
            patients, real_tiles_fn, gene_fn, rna_trainer, rna_state, gan_trainer, gan_state,
            seed=REPS_SEED, tiles_per_patient=args.tiles_per_patient, extractor=extractor,
            save_dir=args.out, condition_mode="population")
        print(f"[reps population] {args.patients} patients x 3 sources in {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        reps_ref = compute_representations(
            patients, real_tiles_fn, gene_fn, rna_trainer, rna_state, gan_trainer, gan_state,
            seed=REPS_SEED, tiles_per_patient=args.tiles_per_patient, extractor=extractor,
            save_dir=os.path.join(args.out, "reference_mode"), condition_mode="reference")
        print(f"[reps reference-mode] in {time.perf_counter() - t0:.1f}s", flush=True)

        def stats(fake_reps):
            return distance_statistics(reps["real"], fake_reps, labels=tissue)

        result = {
            "meta": {"patients": args.patients, "tiles_per_patient": args.tiles_per_patient,
                     "rna_ckpt": rna_path, "gan_ckpt": gan_path, "device": f"{dev} ({kind})"},
            "rnagan_population": stats(reps["rnagan"]),
            "rnagan_reference_mode": stats(reps_ref["rnagan"]),
            "gan_control": stats(reps["gan"]),
        }

    # ---- real-vs-real ceiling: two disjoint held-out halves per patient, the
    # bound any generator could reach in this feature space at this tile count
    half = max(args.tiles_per_patient // 2, 1)
    t0 = time.perf_counter()
    real_a, real_b = (np.stack([mean_activation((render_heldout(corpus, i, offset, half) + 1.0) / 2.0, extractor)
                                for i in range(args.patients)]) for offset in (0, half))
    result["real_vs_real_ceiling"] = distance_statistics(real_a, real_b, labels=tissue)
    print(f"[ceiling] real-vs-real (disjoint halves of {half}) in {time.perf_counter() - t0:.1f}s", flush=True)

    # ---- z-sensitivity in pixel space: one seed for every patient, so the
    # uniforms are equal and the cross-patient delta isolates z; a fresh seed
    # for one patient gives the scale of ordinary noise-driven variation
    t0 = time.perf_counter()
    n_zp, n_zt = min(8, args.patients), 16
    per_patient = [generate_images(rna_trainer, rna_state, n_zt, Z_SEED, gene=gene_fn(patients[i]),
                                   condition_mode="population") for i in range(n_zp)]
    rerun = generate_images(rna_trainer, rna_state, n_zt, Z_SEED + 1, gene=gene_fn(patients[0]),
                            condition_mode="population")
    result["z_sensitivity"] = z_sensitivity(per_patient, rerun)
    print(f"[z-sensitivity] in {time.perf_counter() - t0:.1f}s", flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(stats_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1), flush=True)
    return result


if __name__ == "__main__":
    main()
