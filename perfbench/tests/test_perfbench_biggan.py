"""The published BigGAN's cell: its work counts against a hand count and the
operation counter, its reference's import hygiene, and its per-layer readers
on made-up traces (attention a stage nested in the one that runs it)."""

import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import bench, spec, trace
from perfbench.counts import biggan as counts
from perfbench.reference import biggan

#: ch 1 at 32x32, attention at 16: G after block 1 (16x16); D after every block (the 32 table lists 16 for each)
M = dict(arch="biggan_pub", out_size=32, out_channels=3, step_channels=1, encoding_dims=8, num_classes=2,
         attn_size=16, embed_dim=2, compute_dtype="bfloat16")
VM = dict(rna_features=40, z_dim=8, encoder_dims=(24, 20, 16), decoder_dims=(20, 24))
N = 3
CELL = "rnagan-biggan256.cond-cli-train-b8"


def test_layer_counts_are_the_hand_count():
    """Multiply-adds a sample, by hand: widths 4 (4 x ch), chunks 8 // 4 = 2,
    the conditional BatchNorm's input 2 + 2; attention at 4 channels: theta and
    phi 1 wide, g 2 (T tokens: T * 4 * (1 + 1 + 2 + 2) + T * T / 4 * (1 + 2))."""
    attn16 = 256 * 4 * 6 + 256 * 64 * 3  # 55,296
    attn8 = 64 * 4 * 6 + 64 * 16 * 3  # 4,608
    assert dict(counts.generator_layers(M)) == {
        "linear": 2 * 4 * 16,
        "blocks.0.bn1": 2 * 4 * 4, "blocks.0.conv1": 64 * 4 * 4 * 9, "blocks.0.bn2": 2 * 4 * 4,
        "blocks.0.conv2": 64 * 4 * 4 * 9, "blocks.0.conv_sc": 64 * 4 * 4,
        "blocks.1.bn1": 32, "blocks.1.conv1": 256 * 16 * 9, "blocks.1.bn2": 32, "blocks.1.conv2": 256 * 16 * 9,
        "blocks.1.conv_sc": 256 * 16, "blocks.1.attention": attn16,
        "blocks.2.bn1": 32, "blocks.2.conv1": 1024 * 16 * 9, "blocks.2.bn2": 32, "blocks.2.conv2": 1024 * 16 * 9,
        "blocks.2.conv_sc": 1024 * 16,
        "output_conv": 1024 * 3 * 4 * 9}
    assert dict(counts.discriminator_layers(M)) == {
        "blocks.0.conv1": 1024 * 4 * 3 * 9, "blocks.0.conv2": 1024 * 4 * 4 * 9,
        "blocks.0.conv_sc": 256 * 4 * 3,  # pooled first
        "blocks.0.attention": attn16,
        "blocks.1.conv1": 256 * 16 * 9, "blocks.1.conv2": 256 * 16 * 9, "blocks.1.conv_sc": 256 * 16,
        "blocks.1.attention": attn8,
        "blocks.2.conv1": 64 * 16 * 9, "blocks.2.conv2": 64 * 16 * 9, "blocks.2.attention": attn8,  # identity skip
        "blocks.3.conv1": 64 * 16 * 9, "blocks.3.conv2": 64 * 16 * 9, "blocks.3.attention": attn8,
        "linear": 4}
    G, D = 128 + 19_520 + 77_888 + 55_296 + 311_360 + 110_592, 316_416 + 82_432 + 23_040 + 23_040 + 4
    assert sum(n for _, n in counts.generator_layers(M)) == G
    assert sum(n for _, n in counts.discriminator_layers(M)) == D
    image, last = 1024 * 4 * 3 * 9 + 256 * 4 * 3, 4
    step = (G + 4 * D + 2 * (D - image)) + (3 * D + 2 * (D - last) + (D - last - image)) + (2 * G + 2 * D + G - 128)
    assert counts.step_flops(M, VM, N)["bf16"] == 2 * N * step
    weights = 4 * (4 + 4 + 8 + 8 + 1)  # theta, phi, g, o and gamma in float32
    maps = lambda size: 2 * N * 4 * size * size * 2  # noqa: E731  (a bf16 map read and one written)
    assert counts.attention_forwards(M, N) == {
        "flop": 2 * N * (2 * attn16 + 4 * (attn16 + 3 * attn8)),
        "bytes": 2 * (maps(16) + weights) + 4 * (maps(16) + weights + 3 * (maps(8) + weights))}


def test_forward_counts_equal_the_operation_counter():
    """The forwards' counted operations and the power iterations' (``u W``,
    ``v W^T`` twice and the last dot, per normalized weight: not in the counts)."""
    w = biggan.weights(M, 4, "cpu")
    state = {net: {k: v for k, v in w[net].items() if k.endswith(("running_mean", "running_var", "sn_u"))}
             for net in ("G", "D")}
    labels = torch.tensor([0, 1, 1])
    for net, fn, layers in (
            ("G", lambda: biggan.generator(w["G"], state["G"], torch.randn(N, 8), labels, True, M),
             counts.generator_layers(M)),
            ("D", lambda: biggan.discriminator(w["D"], state["D"], torch.rand(N, 3, 32, 32), labels, True, M),
             counts.discriminator_layers(M))):
        sn = sum(6 * shape[0] * (torch.Size(shape).numel() // shape[0]) + 2 * shape[0]
                 for n, name, shape, kind in biggan.specs(M)[0] if n == net and kind == "ortho"
                 and name != "shared.weight")
        with FlopCounterMode(display=False) as fc:
            fn()
        assert fc.get_total_flops() == 2 * N * sum(c for _, c in layers) + sn, net


def test_parameters_are_the_published_counts():
    m = dict(M, out_size=256, step_channels=64, encoding_dims=2048, attn_size=64, embed_dim=128)
    g = sum(torch.Size(s).numel() for net, _, s, _ in biggan.specs(m)[0] if net == "G")
    assert (g, counts.params(m) - g) == (44_892_036, 43_423_938)
    assert spec.read_json(spec.HERE / "configs" / "rnagan-biggan256.json")["parameters"] == {
        "generator": 44_892_036, "discriminator": 43_423_938, "vae": 303_238_046}


def test_the_reference_and_counts_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.biggan, perfbench.reference.biggan_steps, perfbench.counts.biggan\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('rnagan_tpu_torch', 'rnagan_tpu', 'jax'))\n"
            "print(bad)") % str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


# -------------------------------------------------------------- readers

#: one step: D's forward with its attention nested, the penalty with its own, K3 twice, then ``end``
STEP = [("rnagan_mark_gan_d_forward()", 0.0, 0.00001), ("sm90_xmma_fprop_implicit_gemm", 0.00001, 0.001),
        ("rnagan_mark_gan_attn()", 0.001, 0.00101), ("softmax_warp_forward", 0.00101, 0.0015),
        ("rnagan_mark_gan_d_forward()", 0.0015, 0.00151), ("elementwise_kernel", 0.00151, 0.002),
        ("rnagan_mark_gan_gp()", 0.002, 0.00201), ("sm90_xmma_dgrad", 0.00201, 0.003),
        ("rnagan_mark_gan_attn()", 0.003, 0.00301), ("bmm_kernel", 0.00301, 0.0032),
        ("rnagan_mark_gan_gp()", 0.0032, 0.00321), ("elementwise_kernel", 0.00321, 0.0035),
        ("rnagan_mark_gan_d_adam()", 0.0035, 0.00351), ("fused_adam_kernel", 0.00351, 0.004),
        ("fused_adam_kernel", 0.004, 0.0045), ("rnagan_mark_end()", 0.0045, 0.00451)]
ATTENTION = {"softmax_warp_forward", "bmm_kernel"}


def _profile(steps, attention=True, marks=True):
    ops = []
    for i in range(steps):
        for name, s, e in STEP:
            kept = attention or (name not in ATTENTION and "gan_attn" not in name)
            if kept and (marks or "rnagan_mark" not in name):
                ops.append((name, i * 0.005 + s, i * 0.005 + e))
    return trace.Profile(ops, [], steps * 0.005, steps, {})


def _read(name, p):
    r = bench.Readings(bench.Window(10.0, 100, 800, []), {}, p,
                       {"attn_flop": 2.0e9, "attn_bytes": 1.0e9, "bf16_flop": 1e12, "fp32_flop": 0, "params": 10})
    return spec.Cell(spec.load_benchmark(), CELL).metric_reader(name).read(r)


def test_attention_is_its_own_stage_and_the_enclosing_one_keeps_the_rest():
    p = _profile(4)
    assert _read("biggan_train.attn_ms", p) == pytest.approx(0.49 + 0.19)
    assert _read("biggan_train.gp_ms", p) == pytest.approx(0.99 + 0.29)  # the dgrad and the add after the attention
    # every device ms between the first mark and end, marks left out
    assert _read("biggan_train.model_ms", p) == pytest.approx(0.99 + 0.49 + 0.49 + 0.99 + 0.19 + 0.29)
    least = max(2.0e9 / bench.PEAKS["bf16_flop_per_s"], 1.0e9 / bench.PEAKS["hbm_bytes_per_s"])
    assert _read("biggan_train.attn_roofline", p) == pytest.approx(100.0 * least / (0.68e-3))
    # a net without attention: no gan_attn mark, and the stages hold the same work less the attention's
    q = _profile(4, attention=False)
    assert _read("biggan_train.attn_ms", q) is None and _read("biggan_train.attn_roofline", q) is None
    assert _read("biggan_train.gp_ms", q) == pytest.approx(0.99 + 0.29)
    assert _read("biggan_train.model_ms", q) == pytest.approx(0.99 + 0.49 + 0.99 + 0.29)


def test_a_parent_without_marks_or_counters_reads_nothing(monkeypatch):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"gan.convs": 5})
    p = _profile(4, marks=False)
    for name in ("biggan_train.model_ms", "biggan_train.attn_ms", "biggan_train.attn_roofline", "biggan_train.gp_ms",
                 "biggan_train.sn_share"):
        assert _read(name, p) is None, name
    monkeypatch.setattr(profiling, "counters", {"gan.sn_layers": 30, "gan.layers": 30})
    assert _read("biggan_train.sn_share", p) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "counters", {"gan.sn_layers": 24, "gan.layers": 30})
    assert _read("biggan_train.sn_share", p) == pytest.approx(80.0)
