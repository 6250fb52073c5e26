"""Serving path for tile synthesis (port of ``rnagan_tpu/eval/serving.py``).

At inference the generator's BatchNorms use fixed running statistics, so each
(conv -> BN) pair folds into one conv with a rescaled kernel and a bias::

    y = scale * (conv(x) - mean) / sqrt(var + eps) + bias
      = conv'(x) + bias'    with  k' = k * g,  bias' = bias - g * mean,
                                   g = scale / sqrt(var + eps)

The fold runs in float64. A torch ConvTranspose2d weight is (in, out, kH, kW)
and a Conv2d weight (out, in, kH, kW), so ``g`` runs along axis 1 or 0.

``make_serving_fn`` builds what the JAX package's does, for every arch the
port has:

* ``dcgan``: the folded generator as plain ops (:func:`dcgan_apply`), whose
  head can be swapped for the int8 head (``quantized_head``): the 4x4 VALID
  ConvTranspose on the 1x1 noise map is a (N, z) @ (z, 16 * C0) product
  through the K4 kernel (``kernels/quant_matmul.py``);
* ``quantized_full``: the W8A8 ``dcgan`` stack (:func:`dcgan_int8_apply`);
* ``dcgan_up``: each (2x bilinear upsample -> reflect pad -> 3x3 conv)
  block fused into one stride-2 transposed conv with a 6x6 kernel, the
  2-pixel border recomputed exactly on thin strips (:func:`dcgan_up_apply`);
  the int8 head applies here too;
* ``condgan``: :func:`dcgan_apply` with the labels' one-hot joined to the
  noise before the head, ``fn(noise, labels)``.

``fn``'s output keeps the JAX package's NHWC layout at this public boundary:
uint8 through the fused tanh->uint8 kernel (``kernels/quantize.py``), or
float32 in [-1, 1]. ``fn.generator`` is the stage before it (pre-tanh NCHW
float32) and ``fn.weights`` the tensors it serves from. Under a profiler
``fn`` marks the two on the device as ``synth_generator`` and
``synth_quantize`` (``core/profiling.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.core.device import compute_dtype, resolve_device
from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul, quantize_per_channel
from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8
from rnagan_tpu_torch.models.dcgan import check_arch, join_onehot, num_repeats, up_block

StateDict = Dict[str, torch.Tensor]
_ARCHS = ("dcgan", "dcgan_up", "condgan")


def _fold_pair(sd: StateDict, block: int, out_axis: int):
    w = sd[f"model.{block}.0.weight"].double()
    bn = f"model.{block}.1."
    g = sd[bn + "weight"].double() / torch.sqrt(sd[bn + "running_var"].double() + 1e-5)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    k = w * g.reshape(shape)
    bias = sd[bn + "bias"].double() - g * sd[bn + "running_mean"].double()
    conv_bias = sd.get(f"model.{block}.0.bias")
    if conv_bias is not None:
        bias = bias + g * conv_bias.double()
    return k.float(), bias.float()


def fold_generator(cfg: GANModelConfig, g_state_dict: StateDict):
    """Fold every conv+BN pair of a ``dcgan``, ``condgan`` or ``dcgan_up``
    generator state_dict. Returns ``(folded_cfg, folded_state_dict)``: a
    ``batchnorm=False`` config and float32 weights with biases, equal to the
    eval-mode original. Block b pairs with its own BN (the JAX package sorts
    ``ConvTranspose_0`` before ``Conv_0..r`` to the same pairing)."""
    check_arch(cfg, _ARCHS)
    if not cfg.batchnorm:
        return cfg, {k: v.float() for k, v in g_state_dict.items()}
    r = num_repeats(cfg.out_size)
    folded = {}
    for b in range(r + 1):  # every conv but the last has a BN after it
        out_axis = 0 if cfg.arch == "dcgan_up" and b > 0 else 1  # Conv2d vs ConvTranspose2d
        folded[f"model.{b}.0.weight"], folded[f"model.{b}.0.bias"] = _fold_pair(g_state_dict, b, out_axis)
    for key in (f"model.{r + 1}.0.weight", f"model.{r + 1}.0.bias"):
        folded[key] = g_state_dict[key].float()
    return dataclasses.replace(cfg, batchnorm=False), folded


def _rounded(sd: StateDict, dtype: torch.dtype) -> StateDict:
    """Float32 tensors holding the values rounded to ``dtype`` (the JAX
    package casts the folded parameters to ``weights_dtype``)."""
    return {k: v.to(dtype).float() for k, v in sd.items()}


def _cast(sd: StateDict, dtype: torch.dtype, device) -> StateDict:
    return {k: v.to(device=device, dtype=dtype).contiguous() for k, v in sd.items()}


# ------------------------------------------------------------ quantized head


def head_weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """The 4x4 VALID ConvTranspose head on a 1x1 input is a matmul:
    ``out[n, o, i, j] = sum_c z[n, c] * W[c, o, i, j]`` for the torch
    (in, out, kH, kW) weight, which ``convert.convt_kernel_to_torch`` has
    already flipped. Returns the (Cin, Cout * 16) matrix with columns in
    (o, i, j) order, so the product reshapes to NCHW directly. The JAX
    package's columns run (i, j, o); per-column quantization does not see
    the permutation."""
    return weight.reshape(weight.shape[0], -1)


def quantized_head_fn(folded: StateDict, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """int8 head: z (N, Cin) -> (N, C0, 4, 4) float32 through the K4 kernel.
    ``folded`` = the folded generator's float32 weights."""
    w = folded["model.0.0.weight"]
    cin, cout, kh, kw = w.shape
    w_q, scales = quantize_per_channel(head_weight_matrix(w).cpu().numpy())
    bias = np.repeat(folded["model.0.0.bias"].float().cpu().numpy(), kh * kw)  # per (o, i, j) column
    w_q, scales, bias = (torch.from_numpy(a).to(device) for a in (w_q, scales, bias))

    def fn(z: torch.Tensor) -> torch.Tensor:
        out = int8_matmul(z.float().contiguous(), w_q, scales, bias)
        return out.view(out.shape[0], cout, kh, kw)

    fn.weights = {"model.0.0.weight_q": w_q, "model.0.0.w_scale": scales, "model.0.0.bias": bias}
    return fn


def _head(p: StateDict, noise: torch.Tensor, head_fn, dt: torch.dtype) -> torch.Tensor:
    if head_fn is not None:
        return head_fn(noise).to(dt)
    return F.conv_transpose2d(noise.to(dt)[:, :, None, None], p["model.0.0.weight"], p["model.0.0.bias"])


def dcgan_apply(cfg: GANModelConfig, p: StateDict, noise: torch.Tensor, *,
                head_fn=None, final_tanh: bool = True) -> torch.Tensor:
    """The folded (batchnorm=False) ``dcgan`` generator as plain ops, weights
    ``p`` already in the compute dtype: the counterpart of
    ``dcgan_lax_apply``. A ``head_fn`` output is cast to the compute dtype
    before the LeakyReLU. Returns (N, C, H, W) float32."""
    dt = compute_dtype(cfg.compute_dtype)
    r = num_repeats(cfg.out_size)
    x = F.leaky_relu(_head(p, noise, head_fn, dt), cfg.leaky_slope)
    for b in range(1, r + 2):
        x = F.conv_transpose2d(x, p[f"model.{b}.0.weight"], p[f"model.{b}.0.bias"], 2, 1)
        if b <= r:
            x = F.leaky_relu(x, cfg.leaky_slope)
    x = x.float()
    return torch.tanh(x) if final_tanh else x


# ----------------------------------------------------------------- int8 stack


def quantize_generator_params(cfg: GANModelConfig, folded: StateDict) -> Dict[str, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of every transposed-conv
    weight of a BN-folded ``dcgan`` generator (biases stay float32), in numpy
    float32 as the JAX package computes it. The scales reduce over (H, W, I):
    dims (0, 2, 3) of the torch (I, O, H, W) weight. Returns
    ``model.<b>.0.weight_q`` (int8, torch layout), ``.w_scale`` and ``.bias``:
    :func:`quantize_per_channel` of the (I*H*W, O) view of each weight (its
    zero test differs from JAX's only for a max-abs below 127 * 2**-149)."""
    out = {}
    for b in range(num_repeats(cfg.out_size) + 2):
        w = folded[f"model.{b}.0.weight"].float().cpu().numpy()
        i, o, h, kw = w.shape
        q, s = quantize_per_channel(w.transpose(0, 2, 3, 1).reshape(-1, o))
        out[f"model.{b}.0.weight_q"] = np.ascontiguousarray(q.reshape(i, h, kw, o).transpose(0, 3, 1, 2))
        out[f"model.{b}.0.w_scale"] = s
        out[f"model.{b}.0.bias"] = folded[f"model.{b}.0.bias"].float().cpu().numpy()
    return out


@contextlib.contextmanager
def exact_integer_convs():
    """cuDNN float32 convolutions on the TF32 tensor cores, whatever the caller
    set: an int8 value and the product of two are exact in TF32, and the
    float32 sum of integer products is exact while it stays below 2**24, so
    the convolution equals the JAX package's int32 one. Not thread-safe: it
    sets the process-wide ``torch.backends.cudnn.allow_tf32``, so a conv in
    another thread meanwhile runs in TF32 too, and two threads in here at
    once may restore the wrong value."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _int8_conv_transpose(x: torch.Tensor, q: StateDict, block: int, stride: int,
                         padding: int) -> torch.Tensor:
    """Dynamic per-tensor activation quantization over the whole batch ->
    integer transposed conv -> float32 dequantization with the fused
    activation * weight scale (``serving.py:178-188``). Division is by a
    tensor, so CUDA divides instead of multiplying by a reciprocal."""
    key = f"model.{block}.0."
    a = torch.clamp(x.abs().amax() / torch.tensor(127.0, device=x.device), min=1e-8)
    xq = torch.clamp(torch.round(x / a), -127.0, 127.0)
    with exact_integer_convs():
        y = F.conv_transpose2d(xq, q[key + "weight_q"], None, stride, padding)
    return y * (a * q[key + "w_scale"])[None, :, None, None] + q[key + "bias"][None, :, None, None]


def dcgan_int8_apply(cfg: GANModelConfig, q: StateDict, noise: torch.Tensor, *,
                     final_tanh: bool = True) -> torch.Tensor:
    """W8A8 folded ``dcgan`` generator in float32: every layer quantizes its
    input per tensor on the fly and runs an integer transposed conv. ``q``:
    :func:`quantize_generator_params` as float32 tensors on the device (the
    int8 values widened exactly, for cuDNN). Returns (N, C, H, W)."""
    r = num_repeats(cfg.out_size)
    x = _int8_conv_transpose(noise.float()[:, :, None, None], q, 0, 1, 0)
    x = F.leaky_relu(x, cfg.leaky_slope)
    for b in range(1, r + 1):
        x = F.leaky_relu(_int8_conv_transpose(x, q, b, 2, 1), cfg.leaky_slope)
    x = _int8_conv_transpose(x, q, r + 1, 2, 1)
    return torch.tanh(x) if final_tanh else x


# ------------------------------------------------------- fused resize-conv

_BILINEAR_TAPS = np.array([0.25, 0.75, 0.75, 0.25], np.float64)  # 2x, align_corners=False


def resize_conv_to_transposed(weight3: torch.Tensor) -> torch.Tensor:
    """Fuse (2x bilinear upsample -> 3x3 conv) into ONE stride-2 transposed
    convolution, in weight space (``serving.py:210-234``, in float64).

    Bilinear 2x upsampling is a stride-2 transposed conv with the separable
    tent [.25, .75, .75, .25]; the 3x3 conv after it composes to one
    transposed conv whose 6x6 kernel is the full 2-D correlation of K3 with
    the tent. The JAX package applies that HWIO kernel K6 unflipped with
    ``lax.conv_transpose(strides 2, padding ((3, 3), (3, 3)))``: output
    ``y[p] = sum_t K6[t] x[i]`` over ``p + t - 3 = 2i``. Torch's
    ``conv_transpose2d(stride=2, padding=P)`` gives ``y[p] = sum_t W[t] x[i]``
    over ``2i + t - P = p`` and 2H outputs only for P = 2; with ``t' = 5 - t``
    the JAX sum reads ``2i + t' - 2 = p``, so ``W = flip(K6)``, transposed to
    (in, out, 6, 6): ``convert.convt_kernel_to_torch`` of K6.

    weight3: torch Conv2d (Cout, Cin, 3, 3) -> ConvTranspose2d (Cin, Cout, 6, 6)
    for stride 2, padding 2."""
    k3 = weight3.double().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO, as flax holds it
    tent = np.outer(_BILINEAR_TAPS, _BILINEAR_TAPS)
    kh, kw, cin, cout = k3.shape
    k6 = np.zeros((kh + 3, kw + 3, cin, cout), np.float64)
    for dy in range(kh):
        for dx in range(kw):
            k6[dy:dy + 4, dx:dx + 4] += tent[:, :, None, None] * k3[dy, dx]
    k6 = k6.astype(np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(k6)).to(weight3.device)


def fused_up_block(x: torch.Tensor, weight6: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One fused resize-conv up-block: (N, Cin, H, W) -> (N, Cout, 2H, 2W).
    Exact in the interior; the 2-pixel border sees the transposed conv's
    zeros instead of the edge clamp and the reflection."""
    return F.conv_transpose2d(x, weight6, None, 2, 2) + bias.reshape(1, -1, 1, 1)


def fused_up_block_exact(x: torch.Tensor, weight6: torch.Tensor, weight3: torch.Tensor,
                         bias: torch.Tensor, *, small_exact: int = 16) -> torch.Tensor:
    """Fused up-block with the exact border (``serving.py:260-290``): the
    transposed conv makes the interior, the two-op block remakes the 2-pixel
    frame from 2-row (2-column) input strips, which suffice: upsampled row
    ``u[2i] = .25 x[i-1] + .75 x[i]`` (clamped), so 2 input rows give
    ``u[0..2]``, and output rows 0..1 read only ``u[1], u[0..2]``. Maps with
    H or W at most ``small_exact`` run the two-op block whole."""
    h, w = x.shape[2], x.shape[3]
    if h <= small_exact or w <= small_exact:
        return up_block(x, weight3, bias)
    y = fused_up_block(x, weight6, bias)
    y[:, :, :2] = up_block(x[:, :, :2], weight3, bias)[:, :, :2]
    y[:, :, -2:] = up_block(x[:, :, -2:], weight3, bias)[:, :, -2:]
    y[:, :, :, :2] = up_block(x[:, :, :, :2], weight3, bias)[:, :, :, :2]
    y[:, :, :, -2:] = up_block(x[:, :, :, -2:], weight3, bias)[:, :, :, -2:]
    return y


def fuse_up_generator_params(cfg: GANModelConfig, folded: StateDict,
                             weights_dtype: torch.dtype = torch.float32) -> StateDict:
    """The folded ``dcgan_up`` weights with ``model.<b>.0.weight6``, the fused
    6x6 transposed-conv kernel, added to every up-block b = 1..r+1 (rounded
    to ``weights_dtype`` like the rest)."""
    out = dict(folded)
    for b in range(1, num_repeats(cfg.out_size) + 2):
        out[f"model.{b}.0.weight6"] = resize_conv_to_transposed(
            folded[f"model.{b}.0.weight"]).to(weights_dtype).float()
    return out


def dcgan_up_apply(cfg: GANModelConfig, p: StateDict, noise: torch.Tensor, *, head_fn=None,
                   final_tanh: bool = True, exact_border: bool = True,
                   small_exact: int = 16) -> torch.Tensor:
    """The folded ``dcgan_up`` generator on the fused path (weights ``p`` from
    :func:`fuse_up_generator_params`, in the compute dtype): the head, then one
    stride-2 transposed conv per up-block, borders exact with
    ``exact_border``. Equals ``DCGANUpGenerator`` in eval mode. Returns
    (N, C, H, W) float32."""
    dt = compute_dtype(cfg.compute_dtype)
    r = num_repeats(cfg.out_size)
    x = F.leaky_relu(_head(p, noise, head_fn, dt), cfg.leaky_slope)
    for b in range(1, r + 2):
        w6, w3, bias = p[f"model.{b}.0.weight6"], p[f"model.{b}.0.weight"], p[f"model.{b}.0.bias"]
        if exact_border:
            x = fused_up_block_exact(x, w6, w3, bias, small_exact=small_exact)
        else:
            x = fused_up_block(x, w6, bias)
        if b <= r:
            x = F.leaky_relu(x, cfg.leaky_slope)
    x = x.float()
    return torch.tanh(x) if final_tanh else x


# ------------------------------------------------------------------ builder


def make_serving_fn(cfg: GANModelConfig, g_state_dict: StateDict, *,
                    weights_dtype: Union[str, torch.dtype] = torch.float32,
                    uint8_output: bool = True, quantized_head: bool = False,
                    quantized_full: bool = False, exact_border: bool = True,
                    small_exact: int = 16, device="cuda") -> Callable[..., torch.Tensor]:
    """The synthesis function on ``device``: BN-folded generator with its
    weights rounded to ``weights_dtype``, ending in the tanh->uint8 kernel or
    a float32 tanh. ``quantized_head`` runs the head through the K4 int8
    kernel (``dcgan``, ``dcgan_up``); ``quantized_full`` the W8A8 ``dcgan``
    stack; ``exact_border`` and ``small_exact`` choose ``dcgan_up``'s border
    handling (see :func:`fused_up_block_exact`). Returns ``fn(noise)`` (and
    ``fn(noise, labels)`` for ``condgan``) mapping (N, encoding_dims) noise to
    (N, H, W, C) tiles, uint8 or float32 in [-1, 1]. A ``quantized_full`` fn
    sets cuDNN's process-wide TF32 flag around its convs
    (:func:`exact_integer_convs`): call it from one thread at a time."""
    dev = resolve_device(device)
    check_arch(cfg, _ARCHS)
    wdt = compute_dtype(weights_dtype) if isinstance(weights_dtype, str) else weights_dtype
    dt = compute_dtype(cfg.compute_dtype)
    _, folded = fold_generator(cfg, g_state_dict)
    folded = _rounded(folded, wdt)

    def finish(pre: torch.Tensor) -> torch.Tensor:
        if uint8_output:
            return tanh_to_uint8(pre)
        return torch.tanh(pre).permute(0, 2, 3, 1).contiguous()

    if quantized_full:
        if cfg.arch != "dcgan":
            raise ValueError("quantized_full supports the ConvTranspose dcgan stack")
        q = {k: torch.from_numpy(v).to(dev, torch.float32)
             for k, v in quantize_generator_params(cfg, folded).items()}
        generator = lambda noise: dcgan_int8_apply(cfg, q, noise.to(dev), final_tanh=False)  # noqa: E731
        weights = q
    else:
        # dcgan and dcgan_up share the 4x4 VALID ConvTranspose head, so the
        # int8 head applies to either; the float head then stays on the host
        if quantized_head and cfg.arch == "condgan":
            raise ValueError("quantized_head does not support condgan (one-hot widens the head)")
        head_fn = quantized_head_fn(folded, dev) if quantized_head else None
        if head_fn is not None:
            folded = {k: v for k, v in folded.items() if not k.startswith("model.0.0.")}
        if cfg.arch == "dcgan_up":
            p = _cast(fuse_up_generator_params(cfg, folded, wdt), dt, dev)
            generator = lambda noise: dcgan_up_apply(  # noqa: E731
                cfg, p, noise.to(dev), head_fn=head_fn, final_tanh=False,
                exact_border=exact_border, small_exact=small_exact)
        elif cfg.arch == "condgan":  # dcgan whose head also reads the labels' one-hot
            p = _cast(folded, dt, dev)
            generator = lambda noise, labels: dcgan_apply(  # noqa: E731
                cfg, p, join_onehot(noise.to(dev), labels, cfg.num_classes), final_tanh=False)
        else:
            p = _cast(folded, dt, dev)
            generator = lambda noise: dcgan_apply(cfg, p, noise.to(dev), head_fn=head_fn,  # noqa: E731
                                                  final_tanh=False)
        weights = {**p, **head_fn.weights} if head_fn is not None else p

    @torch.inference_mode()
    def fn(noise: torch.Tensor, *labels: torch.Tensor) -> torch.Tensor:
        profiling.mark("synth_generator", dev)
        pre = generator(noise.float(), *labels)
        profiling.mark("synth_quantize", dev)
        out = finish(pre)
        profiling.mark("end", dev)
        return out

    fn.generator = generator
    fn.weights = weights
    return fn
