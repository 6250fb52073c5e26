"""Per-patient representations (port of ``rnagan_tpu/eval/representation.py``).

For each patient: Inception activations of (a) real tiles, (b) RNA-GAN tiles
conditioned on the patient's expression, (c) unconditional GAN tiles; each
set reduced to its mean activation; one matrix per source, optionally saved
as ``.npy`` (reference ``compute_representation.py:29-101,149-170``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from rnagan_tpu_torch.eval.fid import InceptionExtractor
from rnagan_tpu_torch.eval.generate import generate_images, to_unit_range


def mean_activation(images01, extractor: InceptionExtractor, batch_size: int = 64) -> np.ndarray:
    """Mean 2048-d Inception activation of an image set ([0, 1] NHWC), float32."""
    return extractor(images01, batch_size).mean(dim=0).cpu().numpy()


def compute_representations(patients: Sequence[str], real_tiles_fn: Callable[[str], np.ndarray],
                            gene_fn: Callable[[str], np.ndarray], rna_trainer, rna_state,
                            gan_trainer, gan_state, *, seed: int, tiles_per_patient: int = 64,
                            extractor: Optional[InceptionExtractor] = None,
                            save_dir: Optional[str] = None,
                            condition_mode: str = "reference") -> Dict[str, np.ndarray]:
    """``{"real", "rnagan", "gan"}``, each (P, 2048), optionally written as the
    reference's three ``.npy`` files. Patient i's RNA-GAN tiles take seed
    ``seed + 2 i`` and its GAN tiles ``seed + 2 i + 1`` (the JAX module folds
    i into its key). ``condition_mode`` is :func:`generate_images`'."""
    extractor = extractor or InceptionExtractor()
    reps: Dict[str, list] = {"real": [], "rnagan": [], "gan": []}
    for i, patient in enumerate(patients):
        real01 = to_unit_range(real_tiles_fn(patient))
        rna_imgs = generate_images(rna_trainer, rna_state, tiles_per_patient, seed + 2 * i,
                                   gene=gene_fn(patient), condition_mode=condition_mode)
        gan_imgs = generate_images(gan_trainer, gan_state, tiles_per_patient, seed + 2 * i + 1)
        for name, imgs in (("real", real01), ("rnagan", rna_imgs), ("gan", gan_imgs)):
            reps[name].append(mean_activation(imgs, extractor))
    out = {k: np.stack(v) for k, v in reps.items()}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        for name, arr in out.items():
            np.save(os.path.join(save_dir, f"representations_{name}.npy"), arr)
    return out


def distance_statistics(real_reps: np.ndarray, fake_reps: np.ndarray,
                        labels: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Patient-identity statistics between per-patient mean-activation
    matrices (both (P, D), row i = patient i), whitened by the real set's
    per-dimension mean and std (copy of the JAX module's, ``:66-110``):
    ``frac_own_patient_closest`` (chance is 1/P), ``chance_level``,
    ``mean_margin_vs_median_other``, ``mean_own_distance``,
    ``mean_other_distance``, and with ``labels`` ``frac_nearest_same_label``."""
    mu, sd = real_reps.mean(0), real_reps.std(0) + 1e-12
    real_w = (real_reps - mu) / sd
    fake_w = (fake_reps - mu) / sd
    D = np.linalg.norm(fake_w[:, None, :] - real_w[None, :, :], axis=-1)
    own = np.diag(D)
    # NaN marks the own-patient column for the NaN-aware reductions
    others = np.where(np.eye(len(D), dtype=bool), np.nan, D)
    median_other = np.nanmedian(others, axis=1)
    out = {
        "frac_own_patient_closest": round(float(np.mean(np.argmin(D, axis=1) == np.arange(len(D)))), 4),
        "chance_level": round(1.0 / len(D), 4),
        "mean_margin_vs_median_other": round(float(np.mean((median_other - own) / median_other)), 4),
        "mean_own_distance": round(float(own.mean()), 4),
        "mean_other_distance": round(float(np.nanmean(median_other)), 4),
    }
    if labels is not None:
        labels = np.asarray(labels)
        nn = np.argmin(D, axis=1)
        out["frac_nearest_same_label"] = round(float(np.mean(labels[nn] == labels)), 4)
    return out
