"""Typed configuration for the port (copy of ``rnagan_tpu/core/config.py``).

Field names and defaults are the JAX package's, so a configuration moves
between the two packages field for field. Knobs that only choose a TPU
compute schedule with the same math (``GANModelConfig.convt_impl``,
``remat``) and the training-run fields of ``GANConfig`` are not copied yet:
the serving slice reads none of them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


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
class GANModelConfig:
    """DCGAN-family architecture (reference ``histopathology_gan.py:175-246``)."""

    #: dcgan | dcgan_up | condgan | sagan | biggan (only dcgan is ported yet).
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
    batchnorm: bool = True
    critic: str = "unconditional"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class GANConfig:
    """The serving fields of the GAN run configuration."""

    model: GANModelConfig = field(default_factory=GANModelConfig)
    noise_range: float = 0.3  # U(-0.3, 0.3) infusion noise, wgan_loss.py:100
    seed: int = 99
    #: frozen betaVAE encoder of the wganvae loss family
    vae: VAEModelConfig = field(default_factory=VAEModelConfig)


def load_reference_json(path: str) -> Dict[str, Any]:
    """Load one of the reference's JSON config files verbatim
    (``configs/betavae_tissues.json``, ``configs/gan_run*.json``)."""
    with open(path) as f:
        return json.load(f)
