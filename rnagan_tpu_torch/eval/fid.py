"""Frechet Inception Distance (port of ``rnagan_tpu/eval/fid.py``).

Reference protocol (reference ``src/fid.py``): InceptionV3 ``Mixed_7c`` ->
spatial mean, 2048-d activations of 299x299 inputs in [0, 1]; the mean and
covariance of each set; the Frechet distance with an eps retry on singular
products; 5 repetitions, mean and std.

* :class:`InceptionExtractor` resizes on the device and runs the network at
  a fixed batch (a short last batch is zero-padded, as the JAX extractor
  pads it), bfloat16 by default, float32 features out. The resize to 299 is
  ``jax.image.resize(..., "bilinear")``'s: a separable triangle filter,
  widened by the scale when it shrinks (antialiasing, which
  ``F.interpolate`` leaves out), normalized per output pixel: two matrix
  products with the weights of :func:`resize_weights`.
* :func:`calculate_activation_statistics` gives the mean and the ddof-1
  covariance in float64 (``np.cov(rowvar=False)``), on the activations' device.
* :func:`calculate_frechet_distance`, ``method="eigh"``: tr sqrtm(S1 S2) as
  tr sqrtm(sqrtm(S1) S2 sqrtm(S1)), a symmetric PSD matrix, through float64
  ``torch.linalg.eigh`` on the statistics' device (the JAX package runs its
  eigh in float32, having no x64); negative eigenvalues clipped at 0, the
  eps retry when the trace is not finite. ``method="scipy"`` is the
  reference's ``scipy.linalg.sqrtm`` route, as the JAX package has it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.models.inception import InceptionV3Features

SIZE = 299
Array = Union[np.ndarray, torch.Tensor]


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s bilinear
    ("triangle") kernel with antialiasing (``jax/_src/image/scale.py::
    compute_weight_mat`` at translation 0): out = in^T @ weights per axis."""
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(images: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """(N, H, W, C) float32 -> (N, size, size, C), as ``jax.image.resize(...,
    "bilinear")`` (an axis already of that size is left alone, as JAX does)."""
    n, h, w, c = images.shape
    x = images.float()
    if h != size:
        wh = resize_weights(h, size).to(x.device)
        x = torch.einsum("nhwc,hp->npwc", x, wh)
    if w != size:
        ww = resize_weights(w, size).to(x.device)
        x = torch.einsum("npwc,wq->npqc", x, ww)
    return x


class InceptionExtractor:
    """Batched activation extraction (the JAX ``InceptionExtractor``).
    ``state_dict`` is a torchvision-layout state_dict (``load_fid_inception``,
    ``convert.inception_state_dict_from_jax``) or None for the seeded
    default init. ``device="cuda"`` (the default) raises without CUDA."""

    def __init__(self, state_dict=None, *, transform_input: bool = True, dtype: str = "bfloat16",
                 seed: int = 0, torch_pool: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.model = InceptionV3Features(transform_input=transform_input, torch_pool=torch_pool,
                                         dtype=dtype, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        # weights held in the compute dtype: the same values the layers would
        # cast them to on every call, without the ~470 casts a batch
        self.model.to(self.device, self.model.dtype)

    @torch.inference_mode()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """One batch (N, H, W, C) in [0, 1] on the extractor's device ->
        (N, 2048) float32."""
        return self.model(resize_bilinear(images))

    def __call__(self, images: Array, batch_size: int = 64) -> torch.Tensor:
        """(N, H, W, C) float in [0, 1], any H x W (numpy or a tensor on any
        device) -> (N, 2048) float32 on the extractor's device."""
        n = len(images)
        out = torch.empty((n, 2048), dtype=torch.float32, device=self.device)
        for start in range(0, n, batch_size):
            chunk = torch.as_tensor(images[start:start + batch_size]).to(self.device, torch.float32)
            valid = chunk.shape[0]
            if valid < batch_size:  # a fixed batch, as the JAX extractor keeps it
                pad = chunk.new_zeros((batch_size - valid, *chunk.shape[1:]))
                chunk = torch.cat([chunk, pad])
            out[start:start + valid] = self.features(chunk)[:valid]
        return out


def get_activations(images: Array, batch_size: int = 64,
                    extractor: Optional[InceptionExtractor] = None) -> torch.Tensor:
    extractor = extractor or InceptionExtractor()
    return extractor(images, batch_size)


def activation_statistics(act: Array) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and ddof-1 covariance of (N, D) activations, float64, on their device."""
    a = torch.as_tensor(act).double()
    mu = a.mean(dim=0)
    centered = a - mu
    return mu, centered.T @ centered / (a.shape[0] - 1)


def calculate_activation_statistics(images: Array, batch_size: int = 64,
                                    extractor: Optional[InceptionExtractor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return activation_statistics(get_activations(images, batch_size, extractor))


def _sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root by eigh, tiny negative eigenvalues clipped."""
    vals, vecs = torch.linalg.eigh(mat)
    return (vecs * vals.clamp(min=0.0).sqrt()[None, :]) @ vecs.T


def _trace_sqrtm_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> float:
    """tr sqrtm(S1 @ S2) through the symmetric similarity sqrtm(S1) S2 sqrtm(S1)."""
    a = _sqrtm_psd(sigma1)
    m = a @ sigma2 @ a
    m = 0.5 * (m + m.T)
    return float(torch.linalg.eigvalsh(m).clamp(min=0.0).sqrt().sum())


def _f64(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device or t.device, torch.float64)


def calculate_frechet_distance(mu1: Array, sigma1: Array, mu2: Array, sigma2: Array,
                               eps: float = 1e-6, method: str = "eigh") -> float:
    """d^2 = ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (reference
    ``fid.py:115-163``). ``"eigh"`` computes in float64 on ``sigma1``'s
    device; ``"scipy"`` in numpy, as the reference does."""
    if method == "scipy":
        from scipy import linalg

        to_np = lambda x: np.asarray(torch.as_tensor(x).double().cpu())  # noqa: E731
        mu1, mu2 = np.atleast_1d(to_np(mu1)), np.atleast_1d(to_np(mu2))
        sigma1, sigma2 = np.atleast_2d(to_np(sigma1)), np.atleast_2d(to_np(sigma2))
        diff = mu1 - mu2
        covmean = linalg.sqrtm(sigma1.dot(sigma2))  # (``disp=False`` is deprecated in scipy 1.17)
        if not np.isfinite(covmean).all():
            # eps-jitter path for singular products (reference fid.py:147-152)
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)
    if method != "eigh":
        raise ValueError(f"unknown method {method!r}: 'eigh' or 'scipy'")
    s1 = torch.atleast_2d(_f64(sigma1))
    dev = s1.device
    s2 = torch.atleast_2d(_f64(sigma2, dev))
    diff = torch.atleast_1d(_f64(mu1, dev)) - torch.atleast_1d(_f64(mu2, dev))
    tr_covmean = _trace_sqrtm_product(s1, s2)
    if not math.isfinite(tr_covmean):
        offset = torch.eye(s1.shape[0], dtype=torch.float64, device=dev) * eps
        tr_covmean = _trace_sqrtm_product(s1 + offset, s2 + offset)
    return float(diff.dot(diff) + s1.trace() + s2.trace()) - 2.0 * tr_covmean


def calculate_fid(images1: Array, images2: Array, batch_size: int = 64,
                  extractor: Optional[InceptionExtractor] = None, method: str = "eigh") -> float:
    """FID between two image sets (NHWC float in [0, 1]), reference ``fid.py:217-232``."""
    extractor = extractor or InceptionExtractor()
    mu1, s1 = calculate_activation_statistics(images1, batch_size, extractor)
    mu2, s2 = calculate_activation_statistics(images2, batch_size, extractor)
    return calculate_frechet_distance(mu1, s1, mu2, s2, method=method)


def fid_repetitions(real_images: Array, generate_fn: Callable[[int], Array], n_reps: int = 5,
                    batch_size: int = 64, extractor: Optional[InceptionExtractor] = None
                    ) -> Tuple[float, float, list]:
    """``n_reps`` generations against one real set, mean and (population) std
    of their FIDs (reference ``fid.py:312-330``); ``generate_fn(rep) -> images``."""
    extractor = extractor or InceptionExtractor()
    mu_r, s_r = calculate_activation_statistics(real_images, batch_size, extractor)
    fids = []
    for rep in range(n_reps):
        mu_f, s_f = calculate_activation_statistics(generate_fn(rep), batch_size, extractor)
        fids.append(calculate_frechet_distance(mu_r, s_r, mu_f, s_f))
    return float(np.mean(fids)), float(np.std(fids)), fids
