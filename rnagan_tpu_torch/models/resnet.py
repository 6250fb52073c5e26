"""ResNet family (port of ``rnagan_tpu/models/resnet.py``).

Module names are torchvision's (``conv1``, ``bn1``, ``layerL.B.convN``,
``.bnN``, ``.downsample.0`` / ``.1``, ``fc``), so a torchvision ``state_dict``
loads strictly and ``--backbone_weights`` needs no key mapping;
:func:`state_dict_from_torchvision` adds the JAX package's input-channel
surgery. ``convert.resnet_state_dict_from_jax`` maps the flax names
(``layer1_0/conv1``, ``downsample_conv``, ``downsample_bn``).

The forward takes NCHW and has the JAX module's semantics:

* BatchNorm is flax's (momentum 0.9, eps 1e-5, biased variance;
  ``models/batchnorm.py``); in train mode the running statistics are written
  into the ``BatchNorm2d`` buffers in place;
* max pool 3x3, stride 2, padding 1 (PyTorch pads with -inf, as flax does);
* the convolutions run in ``compute_dtype`` (bfloat16 by default) on cast
  copies of float32 parameters; the global mean is taken in float32, rounded
  to the compute dtype (``jnp.mean`` of a bfloat16 array) and returned in
  float32, as are the ``project`` and ``fc`` heads;
* ``extract=True`` returns the pooled (projected) features.

``num_classes=0`` leaves ``fc`` out: the SimCLR and fusion backbones never
call it, and flax creates no parameters for a head that is never called.
The init follows flax's distributions (lecun-normal kernels, zero biases,
BatchNorm 1/0/0/1), seeded: it matches JAX in statistics, not in bits.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core.device import compute_dtype
from rnagan_tpu_torch.models.batchnorm import batch_norm


@torch.no_grad()
def lecun_normal_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's default init of a Conv or Dense: a ``lecun_normal`` kernel (a
    normal truncated at 2 standard deviations, variance 1/fan_in), a zero
    bias. Drawn on the CPU from ``gen``, so every device starts alike."""
    w = module.weight
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    draw = torch.empty(w.shape)
    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
    w.copy_(draw)
    if module.bias is not None:
        module.bias.zero_()


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    y, mean, var = batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                              train=bn.training)
    if bn.training:
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
    return y


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv3x3(cin, features, stride), nn.BatchNorm2d(features)
        self.conv2, self.bn2 = _conv3x3(features, features), nn.BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        y = _bn(self.bn2, _conv(self.conv2, y))
        if self.downsample is not None:
            x = _bn(self.downsample[1], _conv(self.downsample[0], x))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(cin, features, 1, bias=False), nn.BatchNorm2d(features)
        self.conv2, self.bn2 = _conv3x3(features, features, stride), nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(features * 4)
        self.downsample = _downsample(cin, features * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        y = F.relu(_bn(self.bn2, _conv(self.conv2, y)))
        y = _bn(self.bn3, _conv(self.conv3, y))
        if self.downsample is not None:
            x = _bn(self.downsample[1], _conv(self.downsample[0], x))
        return F.relu(y + x)


class ResNet(nn.Module):
    """``ResNet(block, layers, num_classes, in_channels, compute_dtype,
    project_dim)`` of the JAX package, weights drawn from ``seed``."""

    def __init__(self, block: Type[nn.Module] = Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, in_channels: int = 3, compute_dtype: str = "bfloat16",
                 project_dim: int = 0, *, seed: int = 0, device=None):
        super().__init__()
        self.block, self.layers = block, tuple(layers)
        self.num_classes, self.in_channels = num_classes, in_channels
        self.compute_dtype, self.project_dim = compute_dtype, project_dim
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, features = 64, 64
        for stage, blocks in enumerate(self.layers):
            stride = 1 if stage == 0 else 2
            stack = []
            for b in range(blocks):
                downsample = b == 0 and (stride != 1 or (stage == 0 and block is Bottleneck))
                stack.append(block(cin, features, stride if b == 0 else 1, downsample))
                cin = features * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stack))
            features *= 2
        self.features = cin
        if project_dim:
            self.project = nn.Linear(cin, project_dim)
            cin = project_dim
        self.fc = nn.Linear(cin, num_classes) if num_classes else None
        self._init_weights(seed)
        self.to(device)

    @property
    def out_features(self) -> int:
        """Width of the ``extract=True`` features."""
        return self.project_dim or self.features

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """flax's defaults: :func:`lecun_normal_` convs and Dense layers,
        BatchNorm scale 1, bias 0, mean 0, var 1."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, extract: bool = False) -> torch.Tensor:
        """``x`` (N, C, H, W) -> logits (N, num_classes), or the pooled
        features with ``extract=True``; float32 either way."""
        dt = compute_dtype(self.compute_dtype)
        x = F.relu(_bn(self.bn1, _conv(self.conv1, x.to(dt))))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(len(self.layers)):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.float().mean((2, 3)).to(dt).float()
        if self.project_dim:
            x = self.project(x)
        if extract:
            return x
        if self.fc is None:
            raise ValueError("this ResNet has no fc head (num_classes=0): call it with extract=True")
        return self.fc(x)


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)


ARCHS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
         "resnet101": resnet101, "resnet152": resnet152}


def state_dict_from_torchvision(model: ResNet, state_dict: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` for ``model``
    (``params_from_torch_state_dict`` of the JAX package): the input-channel
    surgery of the reference (``resnet.py:381-435``) makes ``conv1`` 1
    channel (the mean of the RGB kernel) or 4 (that mean appended as a
    fourth); ``fc`` is kept only when its class count is ``model``'s. Keys
    ``model`` does not have (``fc`` of a headless backbone) are left out.
    Returns float32 copies on the CPU (integer counters as they are)."""
    own = model.state_dict()
    sd = {k: torch.as_tensor(v).detach().cpu().clone() for k, v in state_dict.items() if k in own}
    k1 = sd["conv1.weight"].float()
    if model.in_channels == 1:
        sd["conv1.weight"] = k1.mean(1, keepdim=True)
    elif model.in_channels == 4:
        sd["conv1.weight"] = torch.cat([k1, k1.mean(1, keepdim=True)], 1)
    if "fc.weight" in sd and sd["fc.weight"].shape[0] != model.num_classes:
        del sd["fc.weight"], sd["fc.bias"]
    return {k: v if k.endswith("num_batches_tracked") else v.float() for k, v in sd.items()}
