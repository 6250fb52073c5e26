"""Bag aggregation and multimodal fusion heads (port of ``rnagan_tpu/models/fusion.py``).

* :class:`AggregationModel`: ResNet features per tile, the mean over the bag,
  a linear head (reference ``ml_experiments.py:27-47``);
* :class:`FusionModel`: the bag-mean image features concatenated with the
  ``RNAEncoder`` embedding of the patient's expression, ``fuse`` (512) +
  ReLU, then ``head`` (the ``main.py:145-154`` wiring).

Bags come in the JAX package's layout, (B, bag, H, W, C). The backbone is
headless (``num_classes=0``): flax creates no ``fc`` for a backbone called
with ``extract=True``. The RNA encoder is the β-VAE's
(``models/betavae.py::RNAEncoder``: flax dropout with a given keep mask or
one drawn from a seed's Philox stream, flax BatchNorm), float32 as in the JAX
model; its state_dict keys are ``rna_encoder.encoder.{i+1}.{0,1}``
(``convert.resnet_flax_leaf`` maps them to flax's ``RNAEncoder_0/dense_i``,
``bn_i``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core.config import VAEModelConfig
from rnagan_tpu_torch.models.betavae import RNAEncoder
from rnagan_tpu_torch.models.resnet import ResNet, lecun_normal_


def _headless(backbone: ResNet) -> ResNet:
    if backbone.fc is not None:
        raise ValueError("a bag model's backbone has no fc head: build it with num_classes=0")
    return backbone


def bag_features(backbone: ResNet, bags: torch.Tensor) -> torch.Tensor:
    """(B, bag, H, W, C) -> the mean of the bag's tiles' features (B, F), float32."""
    b, bag, h, w, c = bags.shape
    feats = backbone(bags.reshape(b * bag, h, w, c).permute(0, 3, 1, 2), extract=True)
    return feats.reshape(b, bag, -1).mean(1)


class AggregationModel(nn.Module):
    """Bag of tiles -> mean ResNet feature -> linear head (flax's init from ``seed``)."""

    def __init__(self, backbone: ResNet, num_classes: int = 2, *, seed: int = 0, device=None):
        super().__init__()
        self.backbone = _headless(backbone)
        self.head = nn.Linear(backbone.out_features, num_classes, device=device)
        lecun_normal_(self.head, torch.Generator().manual_seed(seed))

    def forward(self, bags: torch.Tensor) -> torch.Tensor:
        return self.head(bag_features(self.backbone, bags))


class FusionModel(nn.Module):
    """Image bags + RNA expression -> joint classification. The Dense layers
    take flax's init (lecun-normal kernels, zero biases) from ``seed``."""

    def __init__(self, backbone: ResNet, rna_features: int,
                 rna_hidden_dims: Sequence[int] = (6000, 4000, 2048), num_classes: int = 2, *,
                 seed: int = 0, device=None):
        super().__init__()
        self.backbone = _headless(backbone)
        self.rna_encoder = RNAEncoder(VAEModelConfig(rna_features=rna_features,
                                                     encoder_dims=tuple(rna_hidden_dims)), device)
        self.fuse = nn.Linear(backbone.out_features + rna_hidden_dims[-1], 512, device=device)
        self.head = nn.Linear(512, num_classes, device=device)
        gen = torch.Generator().manual_seed(seed)
        for m in (*[blk[0] for blk in self.rna_encoder.encoder[1:]], self.fuse, self.head):
            lecun_normal_(m, gen)

    def pre_norm_biases(self) -> Dict[str, str]:
        """Each Dense bias that a BatchNorm follows (the RNA encoder's), by
        name, with its kernel's name. Train-mode BatchNorm subtracts the batch
        mean, so such a bias's true gradient is 0: what it gets is rounding
        noise of the sums behind its kernel's gradient."""
        blocks = range(1, len(self.rna_encoder.encoder))
        return {f"rna_encoder.encoder.{i}.0.bias": f"rna_encoder.encoder.{i}.0.weight" for i in blocks}

    def forward(self, bags: torch.Tensor, rna: torch.Tensor, keep: Optional[torch.Tensor] = None,
                seed=None) -> torch.Tensor:
        """Logits (B, num_classes); in train mode the RNA encoder's input
        dropout takes ``keep`` (bool, ``rna``'s shape) or draws it from
        ``seed``, a host int or a one-element int tensor on the device (a
        captured step's seed row): ``models/betavae.py::draw_keep``."""
        img = bag_features(self.backbone, bags)
        rna_feat = self.rna_encoder(rna.float(), torch.float32, keep, seed=seed)
        joint = F.relu(self.fuse(torch.cat([img, rna_feat.to(img.dtype)], dim=-1)))
        return self.head(joint)
