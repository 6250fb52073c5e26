"""The GAN arch registry (``rnagan_tpu/models/dcgan.py:262-297``, and the
port's ``biggan_pub``): each ``GANModelConfig.arch`` to its nets, and what
the trainer and the CLIs ask of an arch (:func:`takes_labels`,
:func:`spectral_norm`, :func:`cli_defaults`), answered by its generator
class's own traits. Imports point one way: ``dcgan`` <- ``sagan`` <-
``biggan`` <- ``biggan_pub`` <- this module <- the trainer and the CLIs.
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.models.biggan import BigGANDiscriminator, BigGANGenerator
from rnagan_tpu_torch.models.biggan_pub import PublishedBigGANDiscriminator, PublishedBigGANGenerator
from rnagan_tpu_torch.models.dcgan import (ConditionalDCGANDiscriminator, ConditionalDCGANGenerator,
                                           DCGANDiscriminator, DCGANGenerator, DCGANUpGenerator, check_arch)
from rnagan_tpu_torch.models.sagan import SAGANDiscriminator, SAGANGenerator, SNNet

#: arch -> generator class, from each class's ``ARCHS``
GENERATORS: Dict[str, Type[nn.Module]] = {
    arch: cls for cls in (DCGANGenerator, DCGANUpGenerator, ConditionalDCGANGenerator, SAGANGenerator,
                          BigGANGenerator, PublishedBigGANGenerator) for arch in cls.ARCHS}
#: arch -> discriminator class (``dcgan`` and ``dcgan_up`` share the plain one)
DISCRIMINATORS: Dict[str, Type[nn.Module]] = {
    arch: cls for cls in (DCGANDiscriminator, ConditionalDCGANDiscriminator, SAGANDiscriminator,
                          BigGANDiscriminator, PublishedBigGANDiscriminator) for arch in cls.ARCHS}


def _generator_class(cfg: GANModelConfig) -> Type[nn.Module]:
    check_arch(cfg, GENERATORS)
    return GENERATORS[cfg.arch]


def make_generator(cfg: GANModelConfig, **kwargs) -> nn.Module:
    """The generator of ``cfg.arch``; ``kwargs`` (``seed``, ``device``) go to the class."""
    return _generator_class(cfg)(cfg, **kwargs)


def make_discriminator(cfg: GANModelConfig, **kwargs) -> nn.Module:
    """The discriminator of ``cfg.arch``."""
    check_arch(cfg, DISCRIMINATORS)
    return DISCRIMINATORS[cfg.arch](cfg, **kwargs)


def takes_labels(cfg: GANModelConfig) -> bool:
    """Whether ``cfg``'s nets read a batch's labels."""
    return _generator_class(cfg).takes_labels(cfg)


def spectral_norm(cfg: GANModelConfig) -> bool:
    """Whether ``cfg``'s nets carry spectral-norm state ``(u, sigma)``."""
    return issubclass(_generator_class(cfg), SNNet)


def cli_defaults(arch: str) -> Dict[str, int]:
    """The model keys a CLI reads from a run's JSON for ``arch``, with their defaults."""
    return dict(_generator_class(GANModelConfig(arch=arch)).CLI_DEFAULTS)
