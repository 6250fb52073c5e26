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
* flax Conv kernels are HWIO and torch Conv2d weights OIHW; both
  cross-correlate, so the kernel is transposed and not flipped;
* BatchNorm ``scale``/``bias`` + ``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var`` (+ ``num_batches_tracked``);
* SAGAN and BigGAN keep the flax names as module names
  (``models/sagan.py::flax_source``), and flax's spectral-norm state
  (``batch_stats["sn_Conv_1"]["Conv_1/kernel/u"]`` and ``.../sigma``)
  becomes the layer's ``sn_u``/``sn_sigma`` buffers. The ConvTranspose flip
  leaves ``u`` as it is: it only permutes the rows of the ``(-1, out)``
  matrix. ``nn.Embed`` tables carry over as they are;
* InceptionV3's flax tree maps onto torchvision's names
  (:func:`inception_state_dict_from_jax`);
* the ResNet family (``models/resnet.py``, torchvision's names) and the
  fusion and SimCLR models around it map key by key
  (:func:`resnet_flax_leaf`): ``layer1.0.downsample.0`` is flax's
  ``layer1_0/downsample_conv``, the fusion model's ``rna_encoder`` its
  ``RNAEncoder_0`` (``dense_i``, ``bn_i``), SimCLR's ``projection.Dense_i``
  as named.

Adam moments (optax ``mu``/``nu`` trees) move by the same layout transforms,
in the order of the port's ``parameters()``, which is torchgan's. A JAX
``VAETrainState`` moves both ways in flax's state-dict form
(``serialization.to_state_dict``): params, ``batch_stats`` and the optax
chain of ``make_optimizer``. The GAN's nets move back too
(``generator_state_dict_to_jax``, ``discriminator_state_dict_to_jax``,
``sn_state_to_jax``; ``GANTrainer.state_to_jax`` builds the whole state).

The loaders read:

* a reference or JAX-exported betaVAE ``.pt`` state_dict
  (``params_to_torch_state_dict`` + ``torch.save``);
* the ``generator`` entry of a torchgan-layout ``.model`` bundle, which
  ``python -m rnagan_tpu.cli.export_torch`` writes from a JAX-trained checkpoint;
* a whole training bundle of that layout (``load_training_bundle``), which
  ``save_training_bundle`` writes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core.config import GANModelConfig, VAEModelConfig
from rnagan_tpu_torch.models.dcgan import num_repeats

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    # np.array copies: jax-backed arrays are read-only, torch wants owned,
    # C-contiguous memory (a transposed view would otherwise keep its strides)
    return torch.from_numpy(np.array(x, order="C"))


def _put_bn(sd: StateDict, prefix: str, params, stats) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _bn_to_jax(sd: StateDict, prefix: str):
    """The inverse of :func:`_put_bn`: ``({"scale", "bias"}, {"mean", "var"})``."""
    vec = _FROM_TORCH["vec"]
    return ({"scale": vec(sd[prefix + ".weight"]), "bias": vec(sd[prefix + ".bias"])},
            {"mean": vec(sd[prefix + ".running_mean"]), "var": vec(sd[prefix + ".running_var"])})


def betavae_state_dict_from_jax(cfg: VAEModelConfig, variables: Dict[str, Any]) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` of ``BetaVAE`` -> the port's (and the
    reference's) torch state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for lin, dense, bn, bn_path in _vae_layers(cfg):
        leaf = _get(p, dense)
        sd[lin + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[lin + ".bias"] = _t(leaf["bias"])
        if bn:
            _put_bn(sd, bn, _get(p, bn_path), _get(s, bn_path))
    return sd


def convt_kernel_to_torch(k) -> torch.Tensor:
    """flax ConvTranspose HWIO -> torch ConvTranspose2d (in, out, kH, kW), flipped."""
    return _t(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def convt_kernel_from_torch(w) -> np.ndarray:
    """The inverse of :func:`convt_kernel_to_torch`: (in, out, kH, kW) ->
    HWIO, both spatial axes flipped back."""
    return np.ascontiguousarray(_f32(w).transpose(2, 3, 0, 1)[::-1, ::-1])


#: architectures whose nets keep the flax names (``models/sagan.py``, ``models/biggan.py``)
SN_ARCHS = ("sagan", "biggan")


def _layout(cfg: GANModelConfig, net: str) -> torch.nn.Module:
    """The port's net of ``cfg.arch`` on the ``meta`` device: names and
    shapes, no storage."""
    from rnagan_tpu_torch.models.registry import make_discriminator, make_generator

    return (make_generator if net == "generator" else make_discriminator)(cfg, device="meta")


def sn_state_dict_from_jax(cfg: GANModelConfig, net: str, params: Dict[str, Any],
                           stats: Dict[str, Any]) -> StateDict:
    """JAX params/batch_stats of a SAGAN or BigGAN ``net`` -> the port's
    state_dict, key by key through ``flax_source``."""
    from rnagan_tpu_torch.models.sagan import flax_source

    module = _layout(cfg, net)
    sd: StateDict = {}
    for key in module.state_dict():
        col, path, kind = flax_source(module, key)
        if kind == "count":
            sd[key] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[key] = _TO_TORCH[kind](_f32(_get(params if col == "params" else stats, path)))
    return sd


def generator_state_dict_from_jax(cfg: GANModelConfig, params: Dict[str, Any],
                                  stats: Dict[str, Any]) -> StateDict:
    """JAX generator params/batch_stats -> the port's ``model.<b>.0|1`` keys
    (``sagan``/``biggan``: :func:`sn_state_dict_from_jax`).

    ``dcgan`` and ``condgan`` (whose head reads ``encoding_dims + num_classes``
    channels) take torchgan's layout: ``ConvTranspose_b`` is block b, with
    ``_BN_b`` for b <= r when ``cfg.batchnorm``. ``dcgan_up`` takes the port's
    own (``models/dcgan.py``): block 0 is ``ConvTranspose_0`` with ``_BN_0``,
    block b >= 1 is the 3x3 ``Conv_{b-1}`` (with its bias) and ``_BN_b``."""
    if cfg.arch in SN_ARCHS:
        return sn_state_dict_from_jax(cfg, "generator", params, stats)
    if cfg.arch not in ("dcgan", "condgan", "dcgan_up"):
        raise ValueError(f"unknown gan arch {cfg.arch!r}")
    r = num_repeats(cfg.out_size)
    sd: StateDict = {}
    for b in range(r + 2):
        if cfg.arch == "dcgan_up" and b > 0:
            leaf = params[f"Conv_{b - 1}"]
            sd[f"model.{b}.0.weight"] = conv_kernel_to_torch(leaf["kernel"])
        else:
            leaf = params[f"ConvTranspose_{b}"]
            sd[f"model.{b}.0.weight"] = convt_kernel_to_torch(leaf["kernel"])
        if "bias" in leaf:
            sd[f"model.{b}.0.bias"] = _t(leaf["bias"])
        if cfg.batchnorm and b <= r:
            _put_bn(sd, f"model.{b}.1", params[f"_BN_{b}"]["BatchNorm_0"],
                    stats[f"_BN_{b}"]["BatchNorm_0"])
    return sd


def conv_kernel_to_torch(k) -> torch.Tensor:
    """flax Conv HWIO -> torch Conv2d OIHW: a transpose, no flip (both cross-correlate)."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def conv_kernel_from_torch(w) -> np.ndarray:
    """The inverse of :func:`conv_kernel_to_torch`: OIHW -> HWIO."""
    return np.ascontiguousarray(_f32(w).transpose(2, 3, 1, 0))


def discriminator_state_dict_from_jax(cfg: GANModelConfig, params: Dict[str, Any],
                                      stats: Dict[str, Any]) -> StateDict:
    """JAX ``DCGANDiscriminator`` params/batch_stats -> torchgan ``model.<b>.0|1``
    keys (blocks 1..r carry ``_BN_{b-1}`` when ``cfg.batchnorm``), plus
    ``cond_proj.weight`` for the projection critic. ``dcgan_up`` shares the
    layout; ``condgan``'s block 0 reads ``out_channels + num_classes`` channels
    (``sagan``/``biggan``: :func:`sn_state_dict_from_jax`)."""
    if cfg.arch in SN_ARCHS:
        return sn_state_dict_from_jax(cfg, "discriminator", params, stats)
    if cfg.arch not in ("dcgan", "dcgan_up", "condgan"):
        raise ValueError(f"unknown gan arch {cfg.arch!r}")
    r = num_repeats(cfg.out_size)
    sd: StateDict = {}
    for b in range(r + 2):
        leaf = params[f"Conv_{b}"]
        sd[f"model.{b}.0.weight"] = conv_kernel_to_torch(leaf["kernel"])
        if "bias" in leaf:
            sd[f"model.{b}.0.bias"] = _t(leaf["bias"])
        if cfg.batchnorm and 1 <= b <= r:
            _put_bn(sd, f"model.{b}.1", params[f"_BN_{b - 1}"]["BatchNorm_0"],
                    stats[f"_BN_{b - 1}"]["BatchNorm_0"])
    if cfg.critic == "projection":
        sd["cond_proj.weight"] = _t(np.asarray(params["cond_proj"]["kernel"]).T)
    return sd


def _set(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def sn_state_to_jax(cfg: GANModelConfig, net: str, sd: StateDict):
    """The inverse of :func:`sn_state_dict_from_jax`: a SAGAN or BigGAN
    ``net``'s state_dict -> ``(params, batch_stats)`` numpy trees in the flax
    layout, spectral norm's ``u``/``sigma`` included (``num_batches_tracked``,
    which flax does not keep, is dropped)."""
    from rnagan_tpu_torch.models.sagan import flax_source

    module = _layout(cfg, net)
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key in module.state_dict():
        col, path, kind = flax_source(module, key)
        if kind != "count":
            _set(trees[col], path, _FROM_TORCH[kind](sd[key]))
    return trees["params"], trees["batch_stats"]


def generator_state_dict_to_jax(cfg: GANModelConfig, sd: StateDict):
    """The inverse of :func:`generator_state_dict_from_jax`: ``(params,
    batch_stats)`` numpy trees (``sagan``/``biggan``: :func:`sn_state_to_jax`)."""
    if cfg.arch in SN_ARCHS:
        return sn_state_to_jax(cfg, "generator", sd)
    if cfg.arch not in ("dcgan", "condgan", "dcgan_up"):
        raise ValueError(f"unknown gan arch {cfg.arch!r}")
    r = num_repeats(cfg.out_size)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for b in range(r + 2):
        w = sd[f"model.{b}.0.weight"]
        if cfg.arch == "dcgan_up" and b > 0:
            name, leaf = f"Conv_{b - 1}", {"kernel": conv_kernel_from_torch(w)}
        else:
            name, leaf = f"ConvTranspose_{b}", {"kernel": convt_kernel_from_torch(w)}
        if f"model.{b}.0.bias" in sd:
            leaf["bias"] = _FROM_TORCH["vec"](sd[f"model.{b}.0.bias"])
        params[name] = leaf
        if cfg.batchnorm and b <= r:
            bp, bs = _bn_to_jax(sd, f"model.{b}.1")
            params[f"_BN_{b}"], stats[f"_BN_{b}"] = {"BatchNorm_0": bp}, {"BatchNorm_0": bs}
    return params, stats


def discriminator_state_dict_to_jax(cfg: GANModelConfig, sd: StateDict):
    """The inverse of :func:`discriminator_state_dict_from_jax`: ``(params,
    batch_stats)`` numpy trees (``sagan``/``biggan``: :func:`sn_state_to_jax`)."""
    if cfg.arch in SN_ARCHS:
        return sn_state_to_jax(cfg, "discriminator", sd)
    if cfg.arch not in ("dcgan", "dcgan_up", "condgan"):
        raise ValueError(f"unknown gan arch {cfg.arch!r}")
    r = num_repeats(cfg.out_size)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for b in range(r + 2):
        leaf = {"kernel": conv_kernel_from_torch(sd[f"model.{b}.0.weight"])}
        if f"model.{b}.0.bias" in sd:
            leaf["bias"] = _FROM_TORCH["vec"](sd[f"model.{b}.0.bias"])
        params[f"Conv_{b}"] = leaf
        if cfg.batchnorm and 1 <= b <= r:
            bp, bs = _bn_to_jax(sd, f"model.{b}.1")
            params[f"_BN_{b - 1}"], stats[f"_BN_{b - 1}"] = {"BatchNorm_0": bp}, {"BatchNorm_0": bs}
    if cfg.critic == "projection":
        params["cond_proj"] = {"kernel": _FROM_TORCH["dense"](sd["cond_proj.weight"])}
    return params, stats


# ------------------------------------------------- parameter lists, moments

_TO_TORCH = {"convt": convt_kernel_to_torch, "conv": conv_kernel_to_torch,
             "dense": lambda a: _t(np.asarray(a).T), "vec": _t}
_FROM_TORCH = {"convt": convt_kernel_from_torch, "conv": conv_kernel_from_torch,
               "dense": lambda a: np.ascontiguousarray(_f32(a).T), "vec": lambda a: _f32(a).copy()}


def param_paths(cfg: GANModelConfig, net: str):
    """``[(flax_path, kind)]`` of the ``"generator"`` or ``"discriminator"`` in
    the port's ``parameters()`` order (torchgan's, ``dcgan_torch.py:159-170``):
    per block the conv kernel, its bias or the BN scale and bias; then the
    projection critic's ``cond_proj``. ``dcgan_up``'s generator blocks b >= 1
    are ``Conv_{b-1}``'s kernel and bias, then ``_BN_b``'s scale and bias.
    ``sagan``/``biggan`` read theirs off the net's own parameters."""
    if net not in ("generator", "discriminator"):
        raise ValueError(f"net must be 'generator' or 'discriminator', not {net!r}")
    if cfg.arch in SN_ARCHS:
        from rnagan_tpu_torch.models.sagan import flax_source

        module = _layout(cfg, net)
        return [flax_source(module, name)[1:] for name, _ in module.named_parameters()]
    gen = net == "generator"
    r = num_repeats(cfg.out_size)
    conv, kind = ("ConvTranspose", "convt") if gen else ("Conv", "conv")
    order = []
    for b in range(r + 2):
        has_bn = cfg.batchnorm and (b <= r if gen else 1 <= b <= r)
        bn = f"_BN_{b if gen else b - 1}"
        bn_paths = [((bn, "BatchNorm_0", "scale"), "vec"), ((bn, "BatchNorm_0", "bias"), "vec")]
        if gen and cfg.arch == "dcgan_up" and b > 0:
            # the resize-conv blocks: a 3x3 Conv_{b-1} that always has a bias
            order += [((f"Conv_{b - 1}", "kernel"), "conv"), ((f"Conv_{b - 1}", "bias"), "vec")]
            order += bn_paths if has_bn else []
            continue
        order.append(((f"{conv}_{b}", "kernel"), kind))
        order += bn_paths if has_bn else [((f"{conv}_{b}", "bias"), "vec")]
    if not gen and cfg.critic == "projection":
        order.append((("cond_proj", "kernel"), "dense"))
    return order


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _f32(leaf) -> np.ndarray:
    """A leaf as float32 numpy; a ``torch.bfloat16`` leaf (how
    ``core/msgpack.py`` reads a bfloat16 array) is widened exactly."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def param_list_from_jax(cfg: GANModelConfig, net: str, tree) -> list:
    """A flax-layout tree shaped like the net's ``params`` (the parameters or
    an optax moment of them, float32 or bfloat16) -> float32 tensors in the
    port's ``parameters()`` order and layout."""
    return [_TO_TORCH[kind](_f32(_get(tree, path))) for path, kind in param_paths(cfg, net)]


def param_list_to_jax(cfg: GANModelConfig, net: str, tensors) -> Dict[str, Any]:
    """The inverse of :func:`param_list_from_jax`: a float32 numpy tree in the
    flax layout."""
    tree: Dict[str, Any] = {}
    for (path, kind), t in zip(param_paths(cfg, net), tensors, strict=True):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _FROM_TORCH[kind](t)
    return tree


def adam_moments_from_jax(cfg: GANModelConfig, net: str, mu_tree, nu_tree):
    """optax ``ScaleByAdamState.mu``/``nu`` -> ``(mus, nus)``, the state of the
    port's :class:`rnagan_tpu_torch.optim.adam.Adam` (float32; a bf16 mu is
    widened exactly)."""
    return param_list_from_jax(cfg, net, mu_tree), param_list_from_jax(cfg, net, nu_tree)


def adam_moments_to_jax(cfg: GANModelConfig, net: str, mus, nus):
    """``(mu_tree, nu_tree)``, float32 numpy trees in the flax layout."""
    return param_list_to_jax(cfg, net, mus), param_list_to_jax(cfg, net, nus)


# ------------------------------------------------------ betaVAE training state


def _vae_layers(cfg: VAEModelConfig):
    """``(torch Linear, flax Dense path, torch BatchNorm or None, flax BN
    path)`` of each layer of ``BetaVAE``, in module order."""
    n_enc, n_dec = len(cfg.encoder_dims), len(cfg.decoder_dims)
    layers = [(f"encoder.encoder.{i + 1}.0", ("encoder", f"dense_{i}"), f"encoder.encoder.{i + 1}.1",
               ("encoder", f"bn_{i}")) for i in range(n_enc)]
    layers += [("z_mu", ("z_mu",), None, None), ("z_logvar", ("z_logvar",), None, None)]
    layers += [(f"decoder.{i}.0", ("decoder", f"dense_{i}"), f"decoder.{i}.1", ("decoder", f"bn_{i}"))
               for i in range(n_dec)]
    return layers + [(f"decoder.{n_dec}.0", ("decoder", "dense_out"), None, None)]


def vae_param_paths(cfg: VAEModelConfig):
    """``[(torch name, flax path, kind)]`` of ``BetaVAE``'s parameters in the
    port's ``parameters()`` order: per layer the Dense kernel and bias, then
    its BN scale and bias where it has one."""
    order = []
    for lin, dense, bn, bn_path in _vae_layers(cfg):
        order += [(lin + ".weight", (*dense, "kernel"), "dense"), (lin + ".bias", (*dense, "bias"), "vec")]
        if bn:
            order += [(bn + ".weight", (*bn_path, "scale"), "vec"), (bn + ".bias", (*bn_path, "bias"), "vec")]
    return order


def vae_param_list_from_jax(cfg: VAEModelConfig, tree) -> list:
    """A flax-layout tree shaped like ``BetaVAE``'s ``params`` (the parameters
    or an optax moment of them) -> float32 tensors in ``parameters()`` order."""
    return [_TO_TORCH[kind](_f32(_get(tree, path))) for _, path, kind in vae_param_paths(cfg)]


def vae_param_list_to_jax(cfg: VAEModelConfig, tensors) -> Dict[str, Any]:
    """The inverse of :func:`vae_param_list_from_jax`: a float32 numpy tree."""
    tree: Dict[str, Any] = {}
    for (_, path, kind), t in zip(vae_param_paths(cfg), tensors, strict=True):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _FROM_TORCH[kind](t)
    return tree


def betavae_variables_to_jax(cfg: VAEModelConfig, sd: StateDict) -> Dict[str, Any]:
    """The inverse of :func:`betavae_state_dict_from_jax`: ``{'params',
    'batch_stats'}`` numpy trees in the flax layout."""
    stats: Dict[str, Any] = {}
    for _, _, bn, bn_path in _vae_layers(cfg):
        if bn is None:
            continue
        side, name = bn_path
        stats.setdefault(side, {})[name] = {
            "mean": sd[bn + ".running_mean"].detach().cpu().numpy().copy(),
            "var": sd[bn + ".running_var"].detach().cpu().numpy().copy()}
    params = vae_param_list_to_jax(cfg, [sd[name] for name, _, _ in vae_param_paths(cfg)])
    return {"params": params, "batch_stats": stats}


def vae_optimizer_state_from_jax(cfg, opt_tree) -> Dict[str, Any]:
    """The optax state of the JAX ``make_optimizer(cfg)`` (``cfg`` a
    ``VAEConfig``), in flax's state-dict form (``serialization.to_state_dict``:
    a tuple is ``{'0': ..., '1': ...}``), -> the state of the port's
    :class:`~rnagan_tpu_torch.optim.scheduled.ScheduledOptimizer`:
    ``{"count", "rule_count", "mu", "nu"}``. The chain is
    ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`` for
    adam and radam, ``(EmptyState(), ScaleByScheduleState(count))`` for sgd,
    behind ``add_decayed_weights``' empty state when ``weight_decay > 0``."""
    inner = opt_tree["1"] if cfg.weight_decay else opt_tree
    rule = inner["0"]
    out = {"count": int(np.asarray(inner["1"]["count"])), "rule_count": 0, "mu": [], "nu": []}
    if "mu" in rule:
        out.update(rule_count=int(np.asarray(rule["count"])),
                   mu=vae_param_list_from_jax(cfg.model, rule["mu"]),
                   nu=vae_param_list_from_jax(cfg.model, rule["nu"]))
    return out


def vae_optimizer_state_to_jax(cfg, state: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`vae_optimizer_state_from_jax` (numpy leaves)."""
    rule: Dict[str, Any] = {}
    if state["mu"]:
        rule = {"count": np.asarray(state["rule_count"], np.int32),
                "mu": vae_param_list_to_jax(cfg.model, state["mu"]),
                "nu": vae_param_list_to_jax(cfg.model, state["nu"])}
    inner = {"0": rule, "1": {"count": np.asarray(state["count"], np.int32)}}
    return {"0": {}, "1": inner} if cfg.weight_decay else inner


def vae_train_state_from_jax(cfg, tree) -> Dict[str, Any]:
    """A JAX ``VAETrainState`` in flax's state-dict form -> ``{"step",
    "model" (the ``BetaVAE`` state_dict), "optimizer"}``."""
    return {"step": int(np.asarray(tree["step"])),
            "model": betavae_state_dict_from_jax(cfg.model, tree),
            "optimizer": vae_optimizer_state_from_jax(cfg, tree["opt_state"])}


def vae_train_state_to_jax(cfg, step: int, model: StateDict, optimizer: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`vae_train_state_from_jax`: a ``VAETrainState``
    in flax's state-dict form, for ``serialization.from_state_dict``."""
    return {"step": np.asarray(step, np.int32), **betavae_variables_to_jax(cfg.model, model),
            "opt_state": vae_optimizer_state_to_jax(cfg, optimizer)}


# ------------------------------------------------------------- InceptionV3


def inception_state_dict_from_jax(variables: Dict[str, Any]) -> StateDict:
    """JAX ``InceptionV3Features`` ``{'params', 'batch_stats'}`` (or the
    keras-array form of ``models/inception.py::params_from_keras_arrays``) ->
    the torchvision state_dict of the port's ``InceptionV3Features``: each
    BasicConv2d's HWIO ``conv`` kernel to an OIHW ``conv.weight``, its ``bn``
    to ``bn.weight``/``bias``/``running_mean``/``running_var``."""
    sd: StateDict = {}

    def walk(params, stats, prefix):
        for name, sub in params.items():
            if name == "conv":
                sd[prefix + "conv.weight"] = conv_kernel_to_torch(sub["kernel"])
            elif name == "bn":
                _put_bn(sd, prefix + "bn", sub, stats["bn"])
            else:
                walk(sub, stats[name], prefix + name + ".")

    walk(variables["params"], variables["batch_stats"], "")
    return sd


# ------------------------------------------- ResNet, fusion and SimCLR models

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def resnet_flax_leaf(key: str) -> Optional[Tuple[str, Tuple[str, ...], str]]:
    """``(collection, flax path, kind)`` of a state_dict key of the port's
    ``ResNet``, ``FusionModel``, ``AggregationModel`` or SimCLR model; None
    for ``num_batches_tracked``, which flax does not keep."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked":
        return None
    path: list = []
    mods = parts[:-1]
    if mods[0] == "backbone":
        path.append("backbone")
        mods = mods[1:]
    kind = "dense"
    if mods[0] == "rna_encoder":  # rna_encoder.encoder.{i+1}.{0: Dense, 1: BatchNorm}
        i, is_bn = int(mods[2]) - 1, mods[3] == "1"
        path += ["RNAEncoder_0", f"{'bn' if is_bn else 'dense'}_{i}"]
    elif mods[0].startswith("layer"):  # layerL.B.X
        path.append(f"{mods[0]}_{mods[1]}")
        rest, kind = mods[2:], "conv"
        if rest[0] == "downsample":
            is_bn = rest[1] == "1"
            path.append("downsample_bn" if is_bn else "downsample_conv")
        else:
            is_bn = rest[0].startswith("bn")
            path.append(rest[0])
    else:  # conv1, bn1, project, fc, fuse, head, projection.Dense_i
        path += mods
        is_bn = mods[-1] == "bn1"
        kind = "conv" if mods[-1] == "conv1" else "dense"
    if is_bn:
        col, name = _BN_LEAVES[leaf]
        return col, (*path, name), "vec"
    if leaf == "bias":
        return "params", (*path, "bias"), "vec"
    return "params", (*path, "kernel"), kind


def resnet_state_dict_from_jax(model: torch.nn.Module, variables: Dict[str, Any]) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` of a ``ResNet`` (or a fusion or SimCLR
    model) -> ``model``'s state_dict, key by key over ``model``'s own keys
    (``num_batches_tracked`` as ``model`` holds it)."""
    sd: StateDict = {}
    for key, own in model.state_dict().items():
        leaf = resnet_flax_leaf(key)
        if leaf is None:
            sd[key] = own.detach().cpu().clone()
            continue
        col, path, kind = leaf
        sd[key] = _TO_TORCH[kind](_f32(_get(variables[col], path)))
    return sd


def resnet_param_list_from_jax(names, tree) -> list:
    """A flax tree shaped like the model's ``params`` (the parameters or an
    optax moment of them) -> float32 tensors for the parameter ``names``, in
    that order (a trainer's optimizer order)."""
    out = []
    for name in names:
        _, path, kind = resnet_flax_leaf(name)
        out.append(_TO_TORCH[kind](_f32(_get(tree, path))))
    return out


def adamw_state_from_jax(names, opt_state) -> Dict[str, Any]:
    """The state of ``optax.adamw`` (the chain ``(ScaleByAdamState, EmptyState,
    EmptyState)``), or of the fusion trainer's ``multi_transform`` whose
    ``"train"`` part is that chain over the trainable leaves, -> ``{"count",
    "mu", "nu"}`` for the parameter ``names`` (the trainable ones, in the
    optimizer's order) of the port's ``AdamW``. Read by attribute, so optax's
    own state objects serve as they are."""
    if hasattr(opt_state, "inner_states"):
        opt_state = opt_state.inner_states["train"].inner_state
    adam = opt_state[0]
    return {"count": int(np.asarray(adam.count)),
            "mu": resnet_param_list_from_jax(names, adam.mu),
            "nu": resnet_param_list_from_jax(names, adam.nu)}


# ------------------------------------------------------- training bundles

def save_training_bundle(path: str, generator: StateDict, discriminator: StateDict,
                         optimizer_generator: Dict[str, Any],
                         optimizer_discriminator: Dict[str, Any], *, epoch: int = 0,
                         step: Optional[int] = None, g_ema: Optional[StateDict] = None,
                         z_pop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """Write a torchgan-``Trainer``-layout ``.model`` bundle with ``torch.save``,
    the format ``rnagan_tpu/models/dcgan_torch.py::export_torchgan_bundle``
    writes and ``import_torchgan_bundle`` reads: ``epoch`` (epochs done, so
    ``epoch + 1``), the two state_dicts, the two ``torch.optim.Adam``
    state_dicts and empty loss/metric containers. The port's extra keys
    ``step``, ``g_ema`` (generator parameters by name) and ``z_pop``
    (``mean``/``std``) are ignored by readers that do not know them."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    bundle: Dict[str, Any] = {
        "epoch": int(epoch) + 1, "loss_information": {}, "loss_objects": {},
        "metric_objects": {}, "loss_logs": {}, "metric_logs": {},
        "generator": cpu(generator), "discriminator": cpu(discriminator),
        "optimizer_generator": optimizer_generator,
        "optimizer_discriminator": optimizer_discriminator,
    }
    if step is not None:
        bundle["step"] = int(step)
    if g_ema is not None:
        bundle["g_ema"] = cpu(g_ema)
    if z_pop is not None:
        bundle["z_pop"] = {"mean": torch.as_tensor(z_pop[0]).detach().cpu(),
                           "std": torch.as_tensor(z_pop[1]).detach().cpu()}
    torch.save(bundle, path)


def load_training_bundle(path: str) -> Dict[str, Any]:
    """A torchgan-layout ``.model`` bundle as written by
    :func:`save_training_bundle` or the JAX package's ``export_torchgan_bundle``,
    loaded with ``weights_only=True`` onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_betavae_state_dict(path: str) -> StateDict:
    """A betaVAE ``.pt`` state_dict (reference ``model_dict_best.pt`` or a
    JAX export), as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator_state_dict(path: str) -> StateDict:
    """The ``generator`` state_dict of a torchgan-layout ``.model`` bundle.
    Loaded with ``weights_only=True``: the bundle's tensors, numbers and
    containers are read, and no pickled object is executed."""
    return torch.load(path, map_location="cpu", weights_only=True)["generator"]
