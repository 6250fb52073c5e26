"""The rest of tile serving in the port against the JAX package, on the CPU at float32.

The int8 head (K4's plain version against ``pallas_int8_matmul`` in
interpret mode and ``xla_int8_matmul``), the W8A8 generator, the
``dcgan_up`` generator and its fused resize-conv serving, and ``condgan``.
Weights are numpy trees in the JAX layout carried across by the port's
converters; inputs are drawn with numpy and handed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_parity import (_assert_uint8_close, _bn, _uniforms, jax_generator_variables,
                                    jax_vae_variables)
from test_torch_port_train import jax_discriminator_variables

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.eval import serving as jserving
from rnagan_tpu.losses import rna_infusion as jinf
from rnagan_tpu.models import dcgan as jdcgan
from rnagan_tpu.models.betavae import BetaVAE as JaxBetaVAE
from rnagan_tpu.ops.quant_matmul import pallas_int8_matmul, xla_int8_matmul
from rnagan_tpu.ops.quant_matmul import quantize_per_channel as jax_quantize_per_channel
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.eval import serving as tserving
from rnagan_tpu_torch.eval.generate import Synthesizer
from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul, int8_matmul_plain, plan, quantize_per_channel
from rnagan_tpu_torch.models import dcgan as tdcgan
from rnagan_tpu_torch.models import registry as tregistry

F32 = np.float32
KW = dict(out_size=32, encoding_dims=16, step_channels=8, compute_dtype="float32")
NUM_CLASSES = 3


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfgs(**kw):
    kw = {**KW, **kw}
    return jcfg.GANModelConfig(**kw), tcfg.GANModelConfig(**kw)


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1))


def jax_up_generator_variables(cfg, seed=0):
    """Random ``DCGANUpGenerator`` params/batch_stats in the flax layout
    (``ConvTranspose_0``, ``Conv_0..r`` with biases, ``_BN_0..r``), scaled so
    every layer's output is O(1)."""
    rng = np.random.RandomState(seed)
    r = cfg.out_size.bit_length() - 4
    chans = [cfg.step_channels * 2 ** (r - b) for b in range(r + 1)] + [cfg.out_channels]
    head = {"kernel": (rng.randn(4, 4, cfg.encoding_dims, chans[0])
                       / np.sqrt(cfg.encoding_dims)).astype(F32)}
    if not cfg.batchnorm:
        head["bias"] = (0.1 * rng.randn(chans[0])).astype(F32)
    params, stats = {"ConvTranspose_0": head}, {}
    for i in range(r + 1):
        params[f"Conv_{i}"] = {
            "kernel": (rng.randn(3, 3, chans[i], chans[i + 1]) / np.sqrt(9 * chans[i])).astype(F32),
            "bias": (0.1 * rng.randn(chans[i + 1])).astype(F32)}
    if cfg.batchnorm:
        for i in range(r + 1):
            bp, bs = _bn(rng, chans[i])
            params[f"_BN_{i}"], stats[f"_BN_{i}"] = {"BatchNorm_0": bp}, {"BatchNorm_0": bs}
    return params, stats


def _weights(arch, seed=0, **kw):
    """(jax cfg, port cfg, params, stats, port state_dict) of a generator."""
    jc, tc = _cfgs(arch=arch, num_classes=NUM_CLASSES if arch == "condgan" else 0, **kw)
    if arch == "dcgan_up":
        params, stats = jax_up_generator_variables(jc, seed)
    else:  # condgan's head reads the one-hot too
        width = jc.encoding_dims + jc.num_classes
        params, stats = jax_generator_variables(dataclasses.replace(jc, encoding_dims=width), seed)
    return jc, tc, params, stats, convert.generator_state_dict_from_jax(tc, params, stats)


def _noise(rng, n=4, width=KW["encoding_dims"]):
    return rng.randn(n, width).astype(F32)


def _jax_serve(jc, params, stats, z, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jserving.make_serving_fn(jc, params, stats, **kw)(jnp.asarray(z), *args))


def _port_serve(tc, sd, z, *args, **kw):
    return tserving.make_serving_fn(tc, sd, device="cpu", **kw)(torch.from_numpy(z), *args).numpy()


def _max_rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------- K4, int8 head


@pytest.mark.parametrize("shape", [(32, 16), (80, 272)])
def test_quantize_per_channel_bit_equal(rng, shape):
    """The port's copy gives the JAX function's int8 values and scales bit for
    bit, a zero column (scale 1, all zeros) included."""
    w = (rng.randn(*shape) * np.linspace(0.1, 5, shape[1])).astype(F32)
    w[:, 3] = 0.0
    q, s = quantize_per_channel(w)
    jq, js = jax_quantize_per_channel(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert s[3] == 1.0 and not q[:, 3].any()


@pytest.mark.parametrize("n", [8, 5])
def test_int8_matmul_plain_matches_pallas_and_xla(rng, n):
    """K4's plain version (the CPU wrapper's route) against the Pallas kernel
    (interpret mode, block_m 256) and ``xla_int8_matmul``, at N = 8 and a
    ragged N. bf16(x) and the int8 weight are exact in float32, so only the
    order of the float32 sums differs: within 1e-5 of max |out|."""
    x = rng.randn(n, 128).astype(F32)
    q, s = quantize_per_channel(rng.randn(128, 512).astype(F32))
    bias = rng.randn(512).astype(F32)
    args = tuple(map(jnp.asarray, (x, q, s, bias)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(pallas_int8_matmul(*args, block_m=256))
    xla = np.asarray(xla_int8_matmul(*args))
    got = int8_matmul(*(torch.from_numpy(a) for a in (x, q, s, bias)))
    assert got.shape == (n, 512) and got.dtype == torch.float32
    for ref in (pallas, xla):
        assert _max_rel(got.numpy(), ref) <= 1e-5
    assert torch.equal(got, int8_matmul_plain(*(torch.from_numpy(a) for a in (x, q, s, bias))))


@pytest.mark.parametrize("n", [1, 64, 65, 129])
@pytest.mark.parametrize("m", [270, 272])
def test_int8_matmul_plain_matches_pallas_and_xla_at_edge_shapes(rng, n, m):
    """The same at the wgmma kernel's edges: N of one row, of a whole and a
    ragged N tile, over two N tiles; K = 2051 (no multiple of 8, the TMA row
    pitch, nor of 64, the K step); M on the wgmma route (272) and off it
    (270). Within 1e-5 of max |out|."""
    k = 2051
    x = rng.randn(n, k).astype(F32)
    q, s = quantize_per_channel(rng.randn(k, m).astype(F32))
    bias = rng.randn(m).astype(F32)
    args = tuple(map(jnp.asarray, (x, q, s, bias)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(pallas_int8_matmul(*args, block_m=m))
    xla = np.asarray(xla_int8_matmul(*args))
    got = int8_matmul(*(torch.from_numpy(a) for a in (x, q, s, bias))).numpy()
    assert got.shape == (n, m)
    for ref in (pallas, xla):
        assert _max_rel(got, ref) <= 1e-5


@pytest.mark.parametrize("n,m,offset,route,tile_n", [
    (128, 32768, 0, "wgmma", 128), (64, 32768, 0, "wgmma", 64), (1, 32768, 0, "wgmma", 32),
    (32, 512, 0, "wgmma", 32), (33, 512, 0, "wgmma", 64), (65, 512, 0, "wgmma", 128),
    (129, 512, 0, "wgmma", 128), (300, 272, 0, "wgmma", 128), (8, 272, 16, "wgmma", 32),
    (8, 270, 0, "bytewise", 128), (8, 272, 1, "bytewise", 128), (8, 272, 8, "bytewise", 128)])
def test_int8_matmul_route_by_shape(n, m, offset, route, tile_n):
    """K4's kernel is chosen by shape alone: the TMA/wgmma kernel when M is a
    multiple of 16 and the weight starts on 16 bytes (a slice of a larger
    buffer may not), with an N tile of 32, 64 or 128 rows; the byte-wise
    kernel otherwise."""
    k = 64
    w = torch.empty(k * m + offset + 16, dtype=torch.int8)
    base = (-w.data_ptr()) % 16  # the allocation's first 16-byte boundary
    w_q = w[base + offset:base + offset + k * m].view(k, m)
    p = plan(n, k, m, w_q.data_ptr())
    assert (p.route, p.tile_n) == (route, tile_n)


@pytest.mark.parametrize("n,k,m,scratch", [
    (128, 2048, 32768, (128, 2048)), (65, 2051, 272, (65, 2056)), (1, 3, 16, (1, 8)),
    (5, 24, 270, (128, 32)), (129, 33, 270, (256, 64))])
def test_int8_matmul_scratch_sizes(n, k, m, scratch):
    """The bf16 copy of x: N rows and a K pitch of a multiple of 8 for the
    wgmma kernel (TMA zero-fills the rest of each tile); whole 128 x 32
    tiles for the byte-wise kernel."""
    assert plan(n, k, m, 0).scratch == scratch


def test_head_weight_matrix_and_int8_bit_equal(rng):
    """The port's (o, i, j)-column head matrix is JAX's (i, j, o) matrix with
    its columns permuted, bit for bit; so are its int8 values and scales. The
    product equals the ConvTranspose head."""
    cin, cout = 6, 5
    k = rng.randn(4, 4, cin, cout).astype(F32)
    w = convert.convt_kernel_to_torch(k)
    jmat = jserving.head_weight_matrix(k)
    mat = tserving.head_weight_matrix(w).numpy()
    perm = np.arange(16 * cout).reshape(4, 4, cout).transpose(2, 0, 1).ravel()  # (o, i, j) <- (i, j, o)
    np.testing.assert_array_equal(mat, jmat[:, perm])
    q, s = quantize_per_channel(mat)
    jq, js = jax_quantize_per_channel(jmat)
    np.testing.assert_array_equal(q, jq[:, perm])
    np.testing.assert_array_equal(s, js[perm])
    z = rng.randn(3, cin).astype(F32)
    ref = F.conv_transpose2d(torch.from_numpy(z)[:, :, None, None], w)
    np.testing.assert_allclose((z @ mat).reshape(3, cout, 4, 4), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ["dcgan", "dcgan_up"])
@pytest.mark.parametrize("uint8", [False, True])
def test_quantized_head_serving_matches_jax(rng, arch, uint8):
    """``make_serving_fn(quantized_head=True)``: the port's head on the K4
    plain version against the JAX one on the Pallas kernel. Float: 1e-4
    (the convs after the head sum in another order); uint8: at most 1 level
    on under 0.5 % of the values. And the head really is quantized: the
    float-head output differs from it."""
    jc, tc, params, stats, sd = _weights(arch, seed=1)
    z = _noise(rng)
    ref = _jax_serve(jc, params, stats, z, uint8_output=uint8, quantized_head=True)
    got = _port_serve(tc, sd, z, uint8_output=uint8, quantized_head=True)
    assert got.shape == ref.shape == (4, 32, 32, 3)
    if uint8:
        _assert_uint8_close(got, ref, 0.005)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4)
        assert np.abs(got - _port_serve(tc, sd, z, uint8_output=False)).max() > 1e-4


def test_quantized_head_launches_only_on_cuda(rng):
    """A CPU head runs the plain version: the launch counter stays put."""
    _, tc, _, _, sd = _weights("dcgan")
    before = int8_matmul.launches, dict(int8_matmul.launches_by_route)
    fn = tserving.make_serving_fn(tc, sd, device="cpu", quantized_head=True)
    assert fn(torch.from_numpy(_noise(rng))).shape == (4, 32, 32, 3)
    assert (int8_matmul.launches, int8_matmul.launches_by_route) == before
    assert fn.weights["model.0.0.weight_q"].dtype == torch.int8


# ----------------------------------------------------------------- W8A8


def test_quantize_generator_params_bit_equal():
    """Per-output-channel int8 weights and scales of every layer: JAX's after
    the layout change (flip both spatial axes, HWIO -> (I, O, H, W))."""
    jc, tc, params, stats, sd = _weights("dcgan", seed=2)
    _, jfolded = jserving.fold_generator(jc, params, stats)
    jq = jserving.quantize_generator_params(jc, jfolded["params"])
    _, folded = tserving.fold_generator(tc, sd)
    q = tserving.quantize_generator_params(tc, folded)
    for b in range(jc.out_size.bit_length() - 2):
        leaf = jq[f"ConvTranspose_{b}"]
        np.testing.assert_array_equal(
            q[f"model.{b}.0.weight_q"], np.asarray(leaf["kernel_q"])[::-1, ::-1].transpose(2, 3, 0, 1))
        np.testing.assert_array_equal(q[f"model.{b}.0.w_scale"], np.asarray(leaf["w_scale"]))
        np.testing.assert_array_equal(q[f"model.{b}.0.bias"], np.asarray(leaf["bias"]))


def _one_layer(rng, head):
    """A layer's float input (NHWC for JAX) and its quantized parameters in both layouts."""
    cin, cout = (16, 12) if head else (12, 6)
    x = rng.randn(4, 1, 1, cin) if head else rng.randn(4, 6, 5, cin)
    w = (rng.randn(4, 4, cin, cout) * 0.1).astype(F32)
    s = (np.abs(w).max(axis=(0, 1, 2)) / 127.0).astype(F32)
    kq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    bias = rng.randn(cout).astype(F32)
    jleaf = {"kernel_q": jnp.asarray(kq), "w_scale": jnp.asarray(s), "bias": jnp.asarray(bias)}
    tq = {"model.0.0.weight_q": torch.from_numpy(kq[::-1, ::-1].transpose(2, 3, 0, 1).astype(F32)),
          "model.0.0.w_scale": torch.from_numpy(s), "model.0.0.bias": torch.from_numpy(bias)}
    return (x * 3).astype(F32), jleaf, tq


@pytest.mark.parametrize("head", [True, False])
def test_int8_conv_transpose_layer_matches_jax(rng, head):
    """One W8A8 layer, the head (VALID on the 1x1 map) and a stride-2 SAME
    layer: the integer transposed conv is exact on both sides, so the output
    differs only by the float32 epilogue's rounding (1e-6 relative)."""
    x, jleaf, tq = _one_layer(rng, head)
    strides, padding, stride, pad = ((1, 1), "VALID", 1, 0) if head else ((2, 2), "SAME", 2, 1)
    ref = np.asarray(jserving._int8_conv_transpose(jnp.asarray(x), jleaf, strides, padding))
    got = tserving._int8_conv_transpose(torch.from_numpy(x).permute(0, 3, 1, 2), tq, 0, stride, pad)
    assert _nhwc(got).shape == ref.shape
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_dcgan_int8_apply_matches_jax(rng):
    """The W8A8 generator end to end (pre-tanh). Each layer's input is
    rounded to the 127-level grid, so an ulp of difference in the epilogue can
    move a value across a rounding boundary and flip one level; a flip moves a
    pixel by at most a few grid steps. Measured: bit-equal at this size (the
    output spans about +-1); the bound allows flips on 1 % of the pixels,
    each within 0.05, and the rest within 1e-5 relative."""
    jc, tc, params, stats, sd = _weights("dcgan", seed=3)
    _, jfolded = jserving.fold_generator(jc, params, stats)
    jq = jserving.quantize_generator_params(jc, jfolded["params"])
    z = _noise(rng, 6)
    ref = np.asarray(jserving.dcgan_int8_apply(jc, jq, jnp.asarray(z), final_tanh=False))
    _, folded = tserving.fold_generator(tc, sd)
    q = {k: torch.from_numpy(v).float() for k, v in tserving.quantize_generator_params(tc, folded).items()}
    got = _nhwc(tserving.dcgan_int8_apply(tc, q, torch.from_numpy(z), final_tanh=False))
    diff = np.abs(got - ref)
    assert ref.std() > 0.1  # the comparison is not of constants
    assert diff.max() <= 0.05 and (diff > 1e-5 * np.abs(ref).max()).mean() <= 0.01


@pytest.mark.parametrize("uint8", [False, True])
def test_quantized_full_serving_matches_jax(rng, uint8):
    """``make_serving_fn(quantized_full=True)``: float output against JAX's
    (tanh of the above: within 0.05, 1e-5 on 99 %), uint8 against JAX's f32
    egress quantized (its uint8 Pallas epilogue is TPU-only in that test):
    one level on under 1 % of the values."""
    jc, tc, params, stats, sd = _weights("dcgan", seed=4)
    z = _noise(rng)
    ref = _jax_serve(jc, params, stats, z, uint8_output=False, quantized_full=True)
    got = _port_serve(tc, sd, z, uint8_output=uint8, quantized_full=True)
    if uint8:
        ref8 = np.clip(np.trunc((ref * 0.5 + 0.5) * 255 + 0.5), 0, 255).astype(np.uint8)
        _assert_uint8_close(got, ref8, 0.01)
    else:
        diff = np.abs(got - ref)
        assert diff.max() <= 0.05 and (diff > 1e-5).mean() <= 0.01


def test_make_serving_fn_raises_like_jax():
    """The ValueErrors of ``rnagan_tpu/eval/serving.py::make_serving_fn``;
    serving takes the dcgan family only (SAGAN and BigGAN sample through
    ``GANTrainer.sample``)."""
    for arch, kw in (("dcgan_up", {"quantized_full": True}), ("condgan", {"quantized_full": True}),
                     ("condgan", {"quantized_head": True})):
        jc, tc, params, stats, sd = _weights(arch)
        with pytest.raises(ValueError):
            jserving.make_serving_fn(jc, params, stats, **kw)
        with pytest.raises(ValueError, match="quantized"):
            tserving.make_serving_fn(tc, sd, device="cpu", **kw)
    for arch in ("sagan", "biggan"):
        with pytest.raises(ValueError, match=arch):
            tserving.make_serving_fn(tcfg.GANModelConfig(arch=arch, **KW), {}, device="cpu")


@pytest.mark.parametrize("arch", ["dcgan", "dcgan_up"])
def test_weights_dtype_bfloat16_matches_jax(rng, arch):
    """``weights_dtype="bfloat16"`` rounds the folded weights before use, as
    JAX's ``weights_dtype=jnp.bfloat16`` does (compute stays float32)."""
    jc, tc, params, stats, sd = _weights(arch, seed=5)
    z = _noise(rng)
    ref = _jax_serve(jc, params, stats, z, uint8_output=False, weights_dtype=jnp.bfloat16)
    got = _port_serve(tc, sd, z, uint8_output=False, weights_dtype="bfloat16")
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - _port_serve(tc, sd, z, uint8_output=False)).max() > 1e-4


# -------------------------------------------------------------- dcgan_up


@pytest.mark.parametrize("compat_no_tanh", [False, True])
def test_up_generator_eval_matches_jax(rng, compat_no_tanh):
    jc, tc, params, stats, sd = _weights("dcgan_up", seed=6)
    z = _noise(rng, 3)
    ref = jdcgan.DCGANUpGenerator(jc, compat_no_tanh=compat_no_tanh).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z), train=False)
    port = tregistry.make_generator(tc, compat_no_tanh=compat_no_tanh)
    port.load_state_dict(sd)
    np.testing.assert_allclose(_nhwc(port.eval()(torch.from_numpy(z))), np.asarray(ref), atol=1e-5)


def test_up_generator_train_mode_matches_flax(rng):
    """Train mode: output and the running statistics flax writes (biased
    variance, momentum 0.9) through the module's BN buffers."""
    jc, tc, params, stats, sd = _weights("dcgan_up", seed=7)
    z = _noise(rng, 6)
    ref, upd = jdcgan.DCGANUpGenerator(jc).apply({"params": params, "batch_stats": stats},
                                                 jnp.asarray(z), train=True, mutable=["batch_stats"])
    port = tdcgan.DCGANUpGenerator(tc)
    port.load_state_dict(sd)
    np.testing.assert_allclose(_nhwc(port.train()(torch.from_numpy(z))), np.asarray(ref), atol=1e-5)
    r = jc.out_size.bit_length() - 4
    for i, (m, v) in enumerate(port.bn_stats()):
        leaf = upd["batch_stats"][f"_BN_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(_np(m), np.asarray(leaf["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(v), np.asarray(leaf["var"]), rtol=1e-5, atol=1e-6)
    assert len(port.bn_stats()) == r + 1


@pytest.mark.parametrize("h", [4, 8, 11])
def test_upsample_and_reflect_pad_match_jax(rng, h):
    """``F.interpolate`` (clamped source coordinate) equals ``jax.image.resize``
    (renormalized border taps), odd H included; reflect padding is exact."""
    x = rng.randn(2, h, h + 1, 3).astype(F32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    up = tdcgan.upsample2x_bilinear(xt)
    np.testing.assert_allclose(_nhwc(up), np.asarray(jdcgan.upsample2x_bilinear(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_array_equal(_nhwc(tdcgan.reflect_pad_hw(xt, 1)),
                                  np.asarray(jdcgan.reflect_pad_hw(jnp.asarray(x), 1)))


def _up_block_inputs(rng, h):
    x = rng.randn(2, h, h, 3).astype(F32)
    k3 = rng.randn(3, 3, 3, 4).astype(F32)
    bias = rng.randn(4).astype(F32)
    w3 = convert.conv_kernel_to_torch(k3)
    return x, k3, bias, w3


def test_resize_conv_kernel_and_transposed_conv_mapping(rng):
    """The fused 6x6 kernel is JAX's, flipped and transposed, bit for bit
    (both compose in float64); and ``lax.conv_transpose(strides 2, padding
    ((3, 3), (3, 3)))`` with an unflipped HWIO kernel equals
    ``conv_transpose2d(stride 2, padding 2)`` with that kernel flipped."""
    x, k3, bias, w3 = _up_block_inputs(rng, 5)
    k6 = jserving.resize_conv_to_transposed(k3)
    w6 = tserving.resize_conv_to_transposed(w3)
    np.testing.assert_array_equal(w6.numpy(), convert.convt_kernel_to_torch(k6).numpy())
    k = rng.randn(6, 6, 3, 4).astype(F32)
    ref = lax.conv_transpose(jnp.asarray(x), jnp.asarray(k), (2, 2), ((3, 3), (3, 3)),
                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), convert.convt_kernel_to_torch(k),
                             stride=2, padding=2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-4)


def test_fused_up_block_interior_matches_jax(rng):
    """The fused block against JAX's, everywhere, and against the two-op
    block in the interior (the 2-pixel border differs by design)."""
    x, k3, bias, w3 = _up_block_inputs(rng, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w6 = tserving.resize_conv_to_transposed(w3)
    got = _nhwc(tserving.fused_up_block(xt, w6, torch.from_numpy(bias)))
    ref = jserving.fused_up_block(jnp.asarray(x), jnp.asarray(jserving.resize_conv_to_transposed(k3)),
                                  jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
    two_op = _nhwc(tdcgan.up_block(xt, w3, torch.from_numpy(bias)))
    assert got.shape == two_op.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got[:, 2:-2, 2:-2], two_op[:, 2:-2, 2:-2], atol=1e-4)
    assert np.abs(got - two_op).max() > 1e-3  # the border does differ


@pytest.mark.parametrize("small_exact", [16, 2])
@pytest.mark.parametrize("h", [4, 8, 11])
def test_fused_up_block_exact_matches_jax(rng, h, small_exact):
    """The exact-border block equals JAX's and the two-op block everywhere;
    ``small_exact=2`` sends these small maps through the fused conv and the
    edge strips instead of the two-op block."""
    x, k3, bias, w3 = _up_block_inputs(rng, h)
    xt, bt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(bias)
    got = _nhwc(tserving.fused_up_block_exact(xt, tserving.resize_conv_to_transposed(w3), w3, bt,
                                              small_exact=small_exact))
    ref = jserving.fused_up_block_exact(jnp.asarray(x), jnp.asarray(jserving.resize_conv_to_transposed(k3)),
                                        jnp.asarray(k3), jnp.asarray(bias), small_exact=small_exact)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(got, _nhwc(tdcgan.up_block(xt, w3, bt)), atol=2e-4)


@pytest.mark.parametrize("exact_border,small_exact", [(True, 16), (True, 4), (False, 16)])
def test_dcgan_up_serving_matches_jax(rng, exact_border, small_exact):
    """``make_serving_fn(arch="dcgan_up")`` on the fused path against JAX's;
    with the exact border both equal the eval-mode generator."""
    jc, tc, params, stats, sd = _weights("dcgan_up", seed=8)
    z = _noise(rng)
    kw = dict(uint8_output=False, exact_border=exact_border, small_exact=small_exact)
    ref = _jax_serve(jc, params, stats, z, **kw)
    got = _port_serve(tc, sd, z, **kw)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    module = tdcgan.DCGANUpGenerator(tc)
    module.load_state_dict(sd)
    full = _nhwc(module.eval()(torch.from_numpy(z)))
    if exact_border:
        np.testing.assert_allclose(got, full, atol=2e-5)
    else:
        assert np.abs(got - full).max() > 1e-3
    got8 = _port_serve(tc, sd, z, exact_border=exact_border, small_exact=small_exact)
    ref8 = _jax_serve(jc, params, stats, z, exact_border=exact_border, small_exact=small_exact)
    _assert_uint8_close(got8, ref8, 0.005)


def test_dcgan_up_fold_pairs_each_conv_with_its_bn(rng):
    """The folded ``dcgan_up`` weights equal JAX's fold (ConvTranspose_0 with
    _BN_0, Conv_i with _BN_{i+1}) in the port's layout, bit for bit."""
    jc, tc, params, stats, sd = _weights("dcgan_up", seed=9)
    _, jfolded = jserving.fold_generator(jc, params, stats)
    folded_cfg, folded = tserving.fold_generator(tc, sd)
    assert not folded_cfg.batchnorm
    ref = convert.generator_state_dict_from_jax(folded_cfg, jfolded["params"], {})
    assert folded.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(folded[k], v), k


# --------------------------------------------------------------- condgan


def test_conditional_generator_matches_jax(rng):
    jc, tc, params, stats, sd = _weights("condgan", seed=10)
    z, labels = _noise(rng, 5), np.array([0, 2, 1, 2, 0])
    ref = jdcgan.make_generator(jc).apply({"params": params, "batch_stats": stats}, jnp.asarray(z),
                                          labels=jnp.asarray(labels), train=False)
    port = tregistry.make_generator(tc)
    assert isinstance(port, tdcgan.ConditionalDCGANGenerator)
    port.load_state_dict(sd)
    got = port.eval()(torch.from_numpy(z), torch.from_numpy(labels))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="labels"):
        port(torch.from_numpy(z))


@pytest.mark.parametrize("arch", ["condgan", "dcgan_up"])
def test_discriminators_match_jax(rng, arch):
    """``condgan``'s discriminator (one-hot maps after the image channels)
    and the plain one that ``dcgan_up`` shares, in train mode: scores and
    running statistics."""
    jc, tc = _cfgs(arch=arch, num_classes=NUM_CLASSES if arch == "condgan" else 0)
    width = jc.out_channels + jc.num_classes
    params, stats = jax_discriminator_variables(dataclasses.replace(jc, out_channels=width), seed=11)
    x, labels = rng.randn(4, 32, 32, 3).astype(F32), np.array([2, 0, 1, 1])
    kw = {"labels": jnp.asarray(labels)} if arch == "condgan" else {}
    ref, upd = jdcgan.make_discriminator(jc).apply({"params": params, "batch_stats": stats},
                                                   jnp.asarray(x), train=True, mutable=["batch_stats"],
                                                   **kw)
    port = tregistry.make_discriminator(tc)
    port.load_state_dict(convert.discriminator_state_dict_from_jax(tc, params, stats))
    tkw = {"labels": torch.from_numpy(labels)} if arch == "condgan" else {}
    score, new = port(torch.from_numpy(x).permute(0, 3, 1, 2), port.bn_stats(), True, **tkw)
    np.testing.assert_allclose(_np(score), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for i, (m, v) in enumerate(new):
        leaf = upd["batch_stats"][f"_BN_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(_np(m), np.asarray(leaf["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(v), np.asarray(leaf["var"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("uint8", [False, True])
def test_condgan_serving_matches_jax(rng, uint8):
    jc, tc, params, stats, sd = _weights("condgan", seed=12)
    z, labels = _noise(rng), np.array([1, 0, 2, 1])
    ref = _jax_serve(jc, params, stats, z, jnp.asarray(labels), uint8_output=uint8)
    got = _port_serve(tc, sd, z, torch.from_numpy(labels), uint8_output=uint8)
    if uint8:
        _assert_uint8_close(got, ref, 0.005)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)


# ------------------------------------------------------------ whole slice

VAE_KW = dict(rna_features=64, z_dim=16, encoder_dims=(48, 16), decoder_dims=(48,),
              compute_dtype="float32")


@pytest.mark.parametrize("arch", ["dcgan", "condgan"])
def test_slice_quantized_head_matches_jax(rng, arch):
    """``Synthesizer(quantized_head=True)`` (``dcgan``) and the label path
    (``condgan``, float head) against JAX's encode -> infusion with the same
    uniforms -> ``make_serving_fn``: at most one uint8 level apart."""
    jc, tc, params, stats, sd = _weights(arch, seed=13)
    jv, tv = jcfg.VAEModelConfig(**VAE_KW), tcfg.VAEModelConfig(**VAE_KW)
    vae_vars = jax_vae_variables(jv, seed=2)
    gene = rng.randn(6, VAE_KW["rna_features"]).astype(F32)
    u = _uniforms(6)[:, :KW["encoding_dims"]]
    z = jinf.encode_z_mean(JaxBetaVAE(jv), vae_vars, jnp.asarray(gene))
    noise = np.asarray(jinf.standardize_batch(jnp.asarray(u) + z))
    quantized = arch == "dcgan"
    labels = np.array([0, 1, 2, 2, 1, 0])
    extra = () if quantized else (jnp.asarray(labels),)
    ref = _jax_serve(jc, params, stats, noise, *extra, quantized_head=quantized)
    synth = Synthesizer(tcfg.GANConfig(model=tc, vae=tv), convert.betavae_state_dict_from_jax(tv, vae_vars),
                        sd, quantized_head=quantized, device="cpu")
    got = synth.synthesize(gene, u=u, labels=None if quantized else labels).numpy()
    assert got.shape == (6, 32, 32, 3)
    _assert_uint8_close(got, ref, 0.005)
    with pytest.raises(ValueError, match="labels"):
        synth.synthesize(gene, u=u, labels=labels if quantized else None)
