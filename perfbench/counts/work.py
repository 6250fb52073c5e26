"""Operations and bytes of a GAN step, a β-VAE step and a synthesis request.

An operation is one multiply or add of a convolution or matrix product
(2 per multiply-add); elementwise work is not counted. Per layer with
forward multiply-adds ``F``, a backward takes ``F`` for the weight gradient
and ``F`` for the input gradient, each only where something requires it.
"""

from __future__ import annotations

import math
from typing import Dict, List

from perfbench.reference.nets import dcgan_specs, repeats, vae_specs

#: K3's traffic a parameter: read p, g, mu, nu and write p, mu, nu, float32 each
ADAM_BYTES_PER_PARAM = 28


def generator_macs(m: dict) -> List[int]:
    """Multiply-adds a sample of each generator layer, head first."""
    r, step = repeats(m["out_size"]), m["step_channels"]
    c = step * 2 ** r
    macs = [m["encoding_dims"] * c * 16]  # 4x4 head on the 1x1 map
    h = 4
    for cout in [c // 2 ** i for i in range(1, r + 1)] + [m["out_channels"]]:
        macs.append(h * h * c * cout * 16)  # every input pixel meets a 4x4 kernel
        c, h = cout, 2 * h
    return macs


def discriminator_macs(m: dict) -> List[int]:
    """Multiply-adds a sample of each discriminator layer, image side first."""
    r, step = repeats(m["out_size"]), m["step_channels"]
    macs, cin, cout, h = [], m["out_channels"], step, m["out_size"] // 2
    for _ in range(r + 1):
        macs.append(h * h * cout * cin * 16)
        cin, cout, h = cout, 2 * cout, h // 2
    macs.append(cin * 16)  # the 4x4 score layer on the last 4x4 map
    return macs


def encoder_macs(vm: dict) -> int:
    """The frozen encoder's multiply-adds a row up to ``z_mean`` (``z_logvar`` is not needed)."""
    dims = (vm["rna_features"], *vm["encoder_dims"])
    return sum(a * b for a, b in zip(dims, dims[1:])) + dims[-1] * vm["z_dim"]


def gan_step_flops(m: dict, vm: dict, batch: int) -> Dict[str, int]:
    """One ``wganvae`` step with the per-sample GP at ``batch`` rows: bf16 (G, D) and fp32 (encoder)."""
    g, d = generator_macs(m), discriminator_macs(m)
    G, D = sum(g), sum(d)
    d_stage = G + 2 * D + 2 * D + 2 * (D - d[0])  # G; D on real and fake: forward, weight and input gradients
    gp = (D + D  # forward on the interpolates and its input gradient
          + D + (D - d[-1])  # backward through the input-gradient pass: weights, incoming gradients
          + (D - d[-1]) + (D - d[-1] - d[0]))  # and through the forward pass: weights, inputs
    g_stage = G + D + D + G + (G - g[0])  # G and D forward, D's input gradients, G's weight and input gradients
    return {"bf16": 2 * batch * (d_stage + gp + g_stage), "fp32": 2 * batch * encoder_macs(vm)}


def vae_linear_dims(vm: dict) -> List[tuple]:
    dims = (vm["rna_features"], *vm["encoder_dims"])
    layers = list(zip(dims, dims[1:]))
    layers += [(vm["encoder_dims"][-1], vm["z_dim"])] * 2
    dec = (vm["z_dim"], *vm["decoder_dims"], vm["rna_features"])
    return layers + list(zip(dec, dec[1:]))


def vae_step_flops(vm: dict, batch: int) -> Dict[str, int]:
    """One β-VAE train step: forward, weight gradients, input gradients but the first layer's."""
    fwd = sum(a * b for a, b in vae_linear_dims(vm))
    first = vm["rna_features"] * vm["encoder_dims"][0]
    return {"bf16": 0, "fp32": 2 * batch * (3 * fwd - first)}


def synth_request_flops(m: dict, vm: dict, batch: int) -> Dict[str, int]:
    """A synthesis request: the generator's forward in bf16, the encoder's in fp32."""
    return {"bf16": 2 * batch * sum(generator_macs(m)), "fp32": 2 * batch * encoder_macs(vm)}


def dcgan_params(m: dict) -> int:
    return sum(math.prod(shape) for _, _, shape, _ in dcgan_specs(m)[0])


def vae_params(vm: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in vae_specs(vm)[0])


def k2_bytes(m: dict, batch: int) -> int:
    """K2 reads the float32 pre-tanh map and writes the uint8 tiles, each once."""
    pixels = batch * m["out_channels"] * m["out_size"] ** 2
    return 4 * pixels + pixels
