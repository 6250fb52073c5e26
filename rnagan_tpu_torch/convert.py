"""Weights carried across from the JAX package, and the on-disk formats users hold.

The converters take the JAX package's parameter trees (flax ``params`` /
``batch_stats``, as numpy arrays or anything ``np.asarray`` reads) and return
the port's state_dicts. They copy the logic of
``rnagan_tpu/models/betavae.py::params_to_torch_state_dict`` and
``rnagan_tpu/models/dcgan_torch.py::generator_state_dict``:

* flax Dense kernels are (in, out), torch Linear weights (out, in);
* flax ConvTranspose kernels are HWIO and ``lax.conv_transpose`` convolves
  with the spatially flipped kernel, while torch's ConvTranspose2d places it
  unflipped as (in, out, kH, kW): both spatial axes flip in transit;
* BatchNorm ``scale``/``bias`` + ``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var`` (+ ``num_batches_tracked``).

The loaders read:

* a reference or JAX-exported betaVAE ``.pt`` state_dict
  (``params_to_torch_state_dict`` + ``torch.save``);
* the ``generator`` entry of a torchgan-layout ``.model`` bundle, which
  ``python -m rnagan_tpu.cli.export_torch`` writes from a JAX-trained checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rnagan_tpu_torch.core.config import GANModelConfig, VAEModelConfig
from rnagan_tpu_torch.models.dcgan import num_repeats

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    # np.array copies: jax-backed arrays are read-only, torch wants owned memory
    return torch.from_numpy(np.array(x))


def _put_bn(sd: StateDict, prefix: str, params, stats) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def betavae_state_dict_from_jax(cfg: VAEModelConfig, variables: Dict[str, Any]) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` of ``BetaVAE`` -> the port's (and the
    reference's) torch state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}

    def put_linear(prefix, leaf):
        sd[prefix + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[prefix + ".bias"] = _t(leaf["bias"])

    for i in range(len(cfg.encoder_dims)):
        put_linear(f"encoder.encoder.{i + 1}.0", p["encoder"][f"dense_{i}"])
        _put_bn(sd, f"encoder.encoder.{i + 1}.1", p["encoder"][f"bn_{i}"], s["encoder"][f"bn_{i}"])
    put_linear("z_mu", p["z_mu"])
    put_linear("z_logvar", p["z_logvar"])
    for i in range(len(cfg.decoder_dims)):
        put_linear(f"decoder.{i}.0", p["decoder"][f"dense_{i}"])
        _put_bn(sd, f"decoder.{i}.1", p["decoder"][f"bn_{i}"], s["decoder"][f"bn_{i}"])
    put_linear(f"decoder.{len(cfg.decoder_dims)}.0", p["decoder"]["dense_out"])
    return sd


def convt_kernel_to_torch(k) -> torch.Tensor:
    """flax ConvTranspose HWIO -> torch ConvTranspose2d (in, out, kH, kW), flipped."""
    return _t(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def generator_state_dict_from_jax(cfg: GANModelConfig, params: Dict[str, Any],
                                  stats: Dict[str, Any]) -> StateDict:
    """JAX ``DCGANGenerator`` params/batch_stats -> torchgan ``model.<b>.0|1`` keys.

    Blocks 0..r carry ``_BN_b`` when ``cfg.batchnorm``; the last ConvTranspose
    carries a bias."""
    if cfg.arch != "dcgan":
        raise NotImplementedError(f"arch={cfg.arch!r}: the torchgan layout covers 'dcgan' only")
    r = num_repeats(cfg.out_size)
    sd: StateDict = {}
    for b in range(r + 2):
        leaf = params[f"ConvTranspose_{b}"]
        sd[f"model.{b}.0.weight"] = convt_kernel_to_torch(leaf["kernel"])
        if "bias" in leaf:
            sd[f"model.{b}.0.bias"] = _t(leaf["bias"])
        if cfg.batchnorm and b <= r:
            _put_bn(sd, f"model.{b}.1", params[f"_BN_{b}"]["BatchNorm_0"],
                    stats[f"_BN_{b}"]["BatchNorm_0"])
    return sd


def load_betavae_state_dict(path: str) -> StateDict:
    """A betaVAE ``.pt`` state_dict (reference ``model_dict_best.pt`` or a
    JAX export), as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator_state_dict(path: str) -> StateDict:
    """The ``generator`` state_dict of a torchgan-layout ``.model`` bundle.
    Loaded with ``weights_only=True``: the bundle's tensors, numbers and
    containers are read, and no pickled object is executed."""
    return torch.load(path, map_location="cpu", weights_only=True)["generator"]
