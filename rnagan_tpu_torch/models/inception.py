"""InceptionV3 feature extractor for FID (port of ``rnagan_tpu/models/inception.py``).

torchvision's ``inception_v3`` up to ``Mixed_7c``, then the spatial mean: the
2048-d pool3 features of the reference FID (reference ``src/fid.py:33-63``).
Module names and the state_dict are torchvision's: ``X.conv.weight`` (OIHW,
no bias) and ``X.bn.{weight,bias,running_mean,running_var}`` for every
BasicConv2d (conv, BatchNorm in eval mode with eps 1e-3, ReLU), so a
torchvision ``.pth`` loads as it is (its ``fc``/``AuxLogits`` entries are
dropped). Layout is NCHW inside; the input is NHWC, as in the JAX module.

As in the JAX module (``:176-213``):

* the input, NHWC float in [0, 1] at 299x299, becomes ``x*2-1`` and, with
  ``transform_input``, torchvision's channel remap, both in float32 before
  the cast to the compute dtype;
* ``torch_pool`` selects the 3x3/1 average pools' border rule: False divides
  by the valid taps (TF/keras, pytorch-fid), True by 9 (torchvision's
  ``count_include_pad``);
* the max pools are 3x3/2 without padding;
* parameters stay float32; ``dtype`` runs the layers on cast copies and the
  features come back float32.

Weights: :func:`load_fid_inception` reads a torchvision ``.pth`` or keras
arrays (``.npz``; ``.h5`` needs ``h5py``, imported only then). Without them
the default is the port's own seeded init, drawn from a ``torch.Generator``
in the distribution of flax's (lecun-normal kernels, BN scale 1, bias 0,
mean 0, var 1). It is not the JAX package's random init (that is
``jax.random``'s), so the two packages' features and FIDs agree only when
both are given the same weights. Neither is a trained network: an FID from
either is a pipeline check, not comparable with published FIDs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: torchvision's ``transform_input`` (ImageNet mean/std mapped into the
#: network's [-1, 1] input): per channel, ``x * a + b``
_TRANSFORM = ((0.229 / 0.5, (0.485 - 0.5) / 0.5), (0.224 / 0.5, (0.456 - 0.5) / 0.5),
              (0.225 / 0.5, (0.406 - 0.5) / 0.5))


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, bn = x.dtype, self.bn
        x = F.conv2d(x, self.conv.weight.to(dt), None, self.conv.stride, self.conv.padding)
        x = F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt), bn.weight.to(dt),
                         bn.bias.to(dt), False, 0.0, bn.eps)
        return F.relu(x)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    torch_pool: bool = False

    def avg_pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=self.torch_pool)


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(self.avg_pool(x))], 1)


class InceptionB(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(_Block):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(self.avg_pool(x))], 1)


class InceptionD(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(self.avg_pool(x))], 1)


class InceptionV3Features(nn.Module):
    """Backbone up to ``Mixed_7c`` + spatial mean: (N, 299, 299, 3) float in
    [0, 1] -> (N, 2048) float32. ``seed`` draws the default weights (see the
    module docstring); ``dtype`` is ``"float32"`` or ``"bfloat16"``."""

    def __init__(self, *, transform_input: bool = True, torch_pool: bool = False,
                 dtype: str = "float32", seed: int = 0, device=None):
        super().__init__()
        self.transform_input = transform_input
        self.dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        for block in self.modules():
            if isinstance(block, _Block):
                block.torch_pool = torch_pool
        self._init_weights(seed)
        self.to(device)
        self.eval().requires_grad_(False)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """flax's defaults: ``lecun_normal`` kernels (a normal truncated at 2
        standard deviations, scaled so the variance is 1/fan_in), BN scale 1,
        bias 0, mean 0, var 1. Drawn on the CPU, so every device starts alike."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float() * 2.0 - 1.0  # fid.py:54
        if self.transform_input:
            x = torch.cat([x[..., i:i + 1] * a + b for i, (a, b) in enumerate(_TRANSFORM)], -1)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, "Mixed_" + name)(x)
        return x.mean(dim=(2, 3)).float()  # adaptive average pool to 1x1 (fid.py:61-63)


def _block_conv_paths() -> List[Tuple[str, ...]]:
    """Conv module paths in creation order, the same for torchvision's
    ``Inception3.__init__`` and keras' ``inception_v3`` (copy of the JAX
    module's ``_block_conv_paths``)."""
    A = ["branch1x1", "branch5x5_1", "branch5x5_2",
         "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"]
    B = ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]
    Cc = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
    D = ["branch3x3_1", "branch3x3_2",
         "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"]
    E = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
         "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
         "branch3x3dbl_3b", "branch_pool"]
    paths = [("Conv2d_1a_3x3",), ("Conv2d_2a_3x3",), ("Conv2d_2b_3x3",),
             ("Conv2d_3b_1x1",), ("Conv2d_4a_3x3",)]
    for block, names in [("Mixed_5b", A), ("Mixed_5c", A), ("Mixed_5d", A),
                         ("Mixed_6a", B), ("Mixed_6b", Cc), ("Mixed_6c", Cc),
                         ("Mixed_6d", Cc), ("Mixed_6e", Cc), ("Mixed_7a", D),
                         ("Mixed_7b", E), ("Mixed_7c", E)]:
        paths.extend((block, n) for n in names)
    if len(paths) != 94:
        raise AssertionError(f"expected 94 convs, listed {len(paths)}")
    return paths


KERAS_CONV_ORDER = _block_conv_paths()


def params_from_keras_arrays(kernels, betas, means, variances) -> Dict[str, Any]:
    """flax-layout variables (``{"params", "batch_stats"}``, numpy) from
    keras-InceptionV3 weights given as four lists in conv creation order
    (copy of the JAX module's, ``:286-314``). Keras kernels are HWIO already;
    its BatchNorm has ``scale=False``, so gamma is 1. Use with
    ``transform_input=False, torch_pool=False``."""
    if not (len(kernels) == len(betas) == len(means) == len(variances) == 94):
        raise ValueError(f"expected 94 conv/bn pairs, got {len(kernels)}")
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def node(tree, path):
        for p in path:
            tree = tree.setdefault(p, {})
        return tree

    for path, k, b, m, v in zip(KERAS_CONV_ORDER, kernels, betas, means, variances):
        k = np.asarray(k, np.float32)
        p = node(params, path)
        p["conv"] = {"kernel": k}
        p["bn"] = {"scale": np.ones(k.shape[-1], np.float32), "bias": np.asarray(b, np.float32)}
        node(stats, path)["bn"] = {"mean": np.asarray(m, np.float32), "var": np.asarray(v, np.float32)}
    return {"params": params, "batch_stats": stats}


def params_from_keras_h5(path: str) -> Dict[str, Any]:
    """keras-applications InceptionV3 weights from an ``.h5`` file (needs
    ``h5py``), as flax-layout variables; both ``conv2d``-first and legacy
    ``conv2d_1``-first namings, by numeric order (copy of the JAX module's)."""
    import h5py

    def order_key(name, prefix):
        rest = name[len(prefix):].lstrip("_")
        return int(rest) if rest else 0

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def collect(prefix):
            names = [n for n in root if n == prefix or
                     (n.startswith(prefix + "_") and n[len(prefix) + 1:].isdigit())]
            return sorted(names, key=lambda n: order_key(n, prefix))

        def leaf_arrays(group):
            out = {}

            def visit(_, obj):
                if hasattr(obj, "shape") and hasattr(obj, "dtype"):
                    out[obj.name.rsplit("/", 1)[-1].split(":")[0]] = np.asarray(obj)
            group.visititems(visit)
            return out

        lists: Tuple[list, list, list, list] = ([], [], [], [])
        for cname, bname in zip(collect("conv2d"), collect("batch_normalization")):
            cw, bw = leaf_arrays(root[cname]), leaf_arrays(root[bname])
            for dst, val in zip(lists, (cw["kernel"], bw["beta"], bw["moving_mean"],
                                        bw["moving_variance"])):
                dst.append(val)
    return params_from_keras_arrays(*lists)


def load_fid_inception(weights_path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, bool]]:
    """``(state_dict, module kwargs)`` for FID-Inception weights, the
    conventions matched to their source (the JAX ``load_fid_inception``):

    * ``.pt``/``.pth``: torchvision ``inception_v3_google``, the reference's
      network: ``transform_input=True``, ``torch_pool=True``;
    * ``.npz`` (``kernel_i``, ``beta_i``, ``mean_i``, ``var_i``) or ``.h5``:
      keras-applications InceptionV3: ``transform_input=False``,
      ``torch_pool=False``."""
    from rnagan_tpu_torch import convert

    if weights_path.endswith((".pt", ".pth")):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if k.split(".")[0] not in ("fc", "AuxLogits")}
        return sd, {"transform_input": True, "torch_pool": True}
    if weights_path.endswith(".h5"):
        variables = params_from_keras_h5(weights_path)
    elif weights_path.endswith(".npz"):
        with np.load(weights_path) as data:
            variables = params_from_keras_arrays(
                *[[data[f"{field}_{i}"] for i in range(94)] for field in ("kernel", "beta", "mean", "var")])
    else:
        raise ValueError(f"unsupported inception weights format: {weights_path}")
    return convert.inception_state_dict_from_jax(variables), {"transform_input": False, "torch_pool": False}
