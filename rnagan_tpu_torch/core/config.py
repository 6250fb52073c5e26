"""Typed configuration for the port (copy of ``rnagan_tpu/core/config.py``).

Field names and defaults are the JAX package's, so a configuration moves
between the two packages field for field. Knobs that only choose a TPU
compute schedule with the same math (``GANModelConfig.convt_impl``) are not
copied. The device mesh is: :class:`MeshConfig` lays the ranks of a
``torch.distributed`` process group out as (data, model)
(``parallel/mesh.py``), and every training configuration carries one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """Rank layout (``rnagan_tpu/core/config.py:29-42``): a data axis over
    which the batch is split and a model axis over which the β-VAE's Dense
    layers are split column-wise. ``data=-1`` puts every rank of the process
    group on the data axis (model axis size ``model``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    #: -1 = every rank of the process group on the data axis
    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class VAEModelConfig:
    """betaVAE architecture (reference ``betaVAE.py:63-94``)."""

    rna_features: int = 19198
    z_dim: int = 2048
    encoder_dims: Tuple[int, ...] = (6000, 4000, 2048)
    decoder_dims: Tuple[int, ...] = (4000, 6000)
    beta: float = 0.0005
    dropout_rate: float = 0.5  # torch nn.Dropout() default
    leaky_slope: float = 0.01  # torch nn.LeakyReLU() default
    #: parameters are always float32; compute may run in bfloat16.
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class VAEConfig:
    """betaVAE training run (reference ``configs/betavae_tissues.json`` +
    ``betaVAE_training.py``)."""

    model: VAEModelConfig = field(default_factory=VAEModelConfig)
    lr: float = 5e-5
    weight_decay: float = 0.0
    optimizer: str = "adam"  # adam | sgd | radam (betaVAE_training.py:157-162)
    batch_size: int = 128
    num_epochs: int = 500
    #: GradualWarmupScheduler(total_epoch=1000) wrapping CosineAnnealingLR(500),
    #: stepped per *batch* (reference betaVAE.py:234-235, betaVAE_training.py:165-166).
    warmup_steps: int = 1000
    cosine_steps: int = 500
    log_interval: int = 100
    seed: int = 99
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class GANModelConfig:
    """DCGAN-family architecture (reference ``histopathology_gan.py:175-246``)."""

    #: dcgan | dcgan_up | condgan | sagan | biggan
    arch: str = "dcgan"
    encoding_dims: int = 2048
    out_size: int = 256
    out_channels: int = 3
    step_channels: int = 64
    leaky_slope: float = 0.2
    disc_last_leaky: bool = True
    num_classes: int = 0
    attn_size: int = 32
    embed_dim: int = 128
    #: biggan: recompute each residual block in the backward pass
    #: (``torch.utils.checkpoint``) instead of keeping its activations; the
    #: same math, less memory
    remat: bool = False
    batchnorm: bool = True
    critic: str = "unconditional"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class GANConfig:
    """GAN training run and serving (reference ``histopathology_gan.py`` CLI + literals)."""

    model: GANModelConfig = field(default_factory=GANModelConfig)
    loss_type: str = "wganvae"  # minimax | wgan | wganvae | lsgan
    batch_size: int = 8  # hardcoded in the reference (histopathology_gan.py:94)
    num_epochs: int = 900
    # TTUR Adam (reference histopathology_gan.py:252,257)
    g_lr: float = 1e-4
    d_lr: float = 4e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    # wgan weight clip (reference histopathology_gan.py:270)
    clip: Optional[Tuple[float, float]] = (-0.01, 0.01)
    gp_lambda: float = 10.0  # reference wgan_loss.py:287
    noise_range: float = 0.3  # U(-0.3, 0.3) infusion noise, wgan_loss.py:100
    #: frozen betaVAE ``.pt`` of the wganvae loss family (reference wgan_loss.py:67-69)
    vae_checkpoint: Optional[str] = None
    vae: VAEModelConfig = field(default_factory=VAEModelConfig)
    #: the reference's two D steps a batch: critic loss, then a GP-only step
    #: with one scalar interpolation epsilon and a global gradient norm
    #: (wgan_loss.py:376,43)
    compat_reference_gp: bool = False
    #: a TPU schedule in the JAX package (real and fake as one 2B-batch D
    #: call); the same function as the two-pass step, which the port computes
    fused_critic_batch: bool = False
    #: critic iterations per generator update (G updates on every n_critic-th step)
    n_critic: int = 1
    #: dtype of Adam's first moment ("bfloat16" or None = float32); nu stays float32
    adam_mu_dtype: Optional[str] = None
    #: EMA decay of the generator weights, updated on steps that update G; None = off
    g_ema_decay: Optional[float] = None
    sample_size: int = 64  # per-epoch sample grid (histopathology_gan.py:300)
    seed: int = 99
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class DataConfig:
    """Data-layer knobs shared by the training CLIs (the reference's JSON keys)."""

    path_csv: Tuple[str, ...] = ()
    patch_data_path: Tuple[str, ...] = ()
    img_size: int = 256
    max_patch_per_wsi: int = 400
    rna_features: int = 19198
    bag_size: int = 40
    n_workers: int = 4
    quick: bool = False
    normalizer: str = "standard"  # standard | minmax (read_data.py:488-495)


@dataclass(frozen=True)
class MLConfig:
    """Downstream tile classification (reference ``ml_experiments.py:299,342-345,282``;
    ``rnagan_tpu/train/ml_experiment.py:MLConfig``)."""

    num_classes: int = 2
    lr: float = 3e-5
    weight_decay: float = 0.01
    num_epochs: int = 40
    batch_size: int = 64
    folds: int = 5
    image_size: int = 224
    seed: int = 99
    arch: str = "resnet50"
    mesh: MeshConfig = field(default_factory=MeshConfig)


def load_reference_json(path: str) -> Dict[str, Any]:
    """Load one of the reference's JSON config files verbatim
    (``configs/betavae_tissues.json``, ``configs/gan_run*.json``)."""
    with open(path) as f:
        return json.load(f)


def vae_model_config_from_json(raw: Dict[str, Any]) -> VAEModelConfig:
    """The β-VAE of a pre-train's or a GAN run's JSON dict (the architecture
    keys are extensions, absent from the reference's files)."""
    return VAEModelConfig(
        rna_features=int(raw.get("rna_features", 19198)),
        beta=float(raw.get("beta", 0.0005)),
        z_dim=int(raw.get("z_dim", 2048)),
        encoder_dims=tuple(raw.get("encoder_dims", (6000, 4000, 2048))),
        decoder_dims=tuple(raw.get("decoder_dims", (4000, 6000))),
    )


def vae_config_from_json(raw: Dict[str, Any]) -> VAEConfig:
    """A :class:`VAEConfig` from a reference-format JSON dict (the reads at
    reference ``betaVAE_training.py:53-59``)."""
    return VAEConfig(
        model=vae_model_config_from_json(raw),
        lr=float(raw.get("lr", 5e-5)),
        weight_decay=float(raw.get("weights_decay", 0.0)),
        optimizer=str(raw.get("optimizer", "adam")),
        batch_size=int(raw.get("batch_size", 128)),
        num_epochs=int(raw.get("num_epochs", 500)),
        log_interval=int(raw.get("log_interval", 100)),
    )


def data_config_from_json(raw: Dict[str, Any], num_patches: Optional[int] = None) -> DataConfig:
    return DataConfig(
        path_csv=tuple(raw.get("path_csv", ())),
        patch_data_path=tuple(raw.get("patch_data_path", ())),
        img_size=int(raw.get("img_size", 256)),
        max_patch_per_wsi=int(num_patches if num_patches is not None else raw.get("max_patch_per_wsi", 400)),
        rna_features=int(raw.get("rna_features", 19198)),
        bag_size=int(raw.get("bag_size", 40)),
        n_workers=int(raw.get("n_workers", 4)),
        quick=bool(raw.get("quick", False)),
    )
