"""Operations and bytes of a ``wganvae`` step of the published BigGAN (``reference/biggan.py``).

An operation is one multiply or add of a convolution or a matrix product (2
per multiply-add), as in ``counts/work.py``; elementwise work, the critic's
projection (a dot product) and the power iterations' matrix-vector products
(about three multiply-adds a weight a forward, under 0.1 % of a step at the
published widths) are not counted. A layer with forward multiply-adds ``F``
takes ``F`` for its weight gradient and ``F`` for its input gradient, each
only where something requires it; an attention product's two operands are
both activations, and count as its weight and its input.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench.counts.work import encoder_macs
from perfbench.reference.biggan import attention_widths, chunk, d_blocks, g_blocks, specs

#: attention forwards a step: G in the D and the G stage; D on the real tiles, the fakes, the interpolates
#: and the G stage's fakes
G_ATTENTION_CALLS, D_ATTENTION_CALLS = 2, 4


def attention_macs(c: int, size: int) -> int:
    """Multiply-adds a sample of ``layers.Attention`` at ``c`` channels on a ``size`` x ``size`` map."""
    t = size * size
    qk, v = attention_widths(c)
    return t * c * (2 * qk + 2 * v) + t * (t // 4) * (qk + v)


def generator_layers(m: dict) -> List[Tuple[str, int]]:
    """(name, multiply-adds a sample) of each generator layer in forward order."""
    cond = m["embed_dim"] + chunk(m)
    blocks = g_blocks(m)
    out = [("linear", chunk(m) * blocks[0][0] * 16)]
    for i, (cin, cout, size, attn) in enumerate(blocks):
        hw = size * size
        out += [(f"blocks.{i}.bn1", 2 * cond * cin), (f"blocks.{i}.conv1", hw * cout * cin * 9),
                (f"blocks.{i}.bn2", 2 * cond * cout), (f"blocks.{i}.conv2", hw * cout * cout * 9),
                (f"blocks.{i}.conv_sc", hw * cout * cin)]
        if attn:
            out.append((f"blocks.{i}.attention", attention_macs(cout, size)))
    return out + [("output_conv", m["out_size"] ** 2 * m["out_channels"] * blocks[-1][1] * 9)]


def discriminator_layers(m: dict) -> List[Tuple[str, int]]:
    """(name, multiply-adds a sample) of each critic layer in forward order."""
    out = []
    for i, (cin, cout, pools, size, attn) in enumerate(d_blocks(m)):
        hw, after = size * size, size // 2 if pools else size
        out += [(f"blocks.{i}.conv1", hw * cout * cin * 9), (f"blocks.{i}.conv2", hw * cout * cout * 9)]
        if cin != cout or pools:
            out.append((f"blocks.{i}.conv_sc", (hw if i else after * after) * cout * cin))
        if attn:
            out.append((f"blocks.{i}.attention", attention_macs(cout, after)))
    return out + [("linear", d_blocks(m)[-1][1])]


def step_flops(m: dict, vm: dict, batch: int) -> Dict[str, int]:
    """One ``wganvae`` step with the per-sample GP at ``batch`` rows: bf16 (G, D) and fp32 (the encoder)."""
    g, d = dict(generator_layers(m)), dict(discriminator_layers(m))
    G, D = sum(g.values()), sum(d.values())
    d_image = d["blocks.0.conv1"] + d["blocks.0.conv_sc"]  # the layers that read the tiles: no input gradient
    d_last = d["linear"]  # the score layer: its incoming gradient is a constant
    d_stage = G + 2 * D + 2 * D + 2 * (D - d_image)  # G; D on real and fake: forward, weight and input gradients
    gp = (D + D  # forward on the interpolates and its input gradient
          + D + (D - d_last)  # backward through the input-gradient pass: weights, incoming gradients
          + (D - d_last) + (D - d_last - d_image))  # and through the forward pass: weights, inputs
    g_stage = G + D + D + G + (G - g["linear"])  # G, D forward; D's input gradients; G's weights and inputs (not z's)
    return {"bf16": 2 * batch * (d_stage + gp + g_stage), "fp32": 2 * batch * encoder_macs(vm)}


def params(m: dict) -> int:
    return sum(math.prod(shape) for _, _, shape, _ in specs(m)[0])


def attention_forwards(m: dict, batch: int) -> Dict[str, int]:
    """The attention forwards of a step (:data:`G_ATTENTION_CALLS`,
    :data:`D_ATTENTION_CALLS`): their operations, and their bytes with each
    input map read once, each output map written once (in the compute
    dtype) and each float32 weight read once; the logits never leave the chip."""
    elt = 2 if m.get("compute_dtype", "bfloat16") == "bfloat16" else 4
    flop = nbytes = 0
    for calls, blocks in ((G_ATTENTION_CALLS, [(c, s) for _, c, s, a in g_blocks(m) if a]),
                          (D_ATTENTION_CALLS, [(c, s // 2 if p else s) for _, c, p, s, a in d_blocks(m) if a])):
        for c, size in blocks:
            qk, v = attention_widths(c)
            flop += calls * 2 * batch * attention_macs(c, size)
            nbytes += calls * (2 * batch * c * size * size * elt + 4 * (2 * qk * c + 2 * v * c + 1))
    return {"flop": flop, "bytes": nbytes}
