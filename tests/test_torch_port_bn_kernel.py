"""The train-mode BatchNorm op of a channels-last map (``kernels/batchnorm.py``), on the CPU.

On the card, ``models/batchnorm.py`` sends a train-mode bf16 channels-last
map with C % 8 == 0 (outside a mesh) to one autograd op backed by the
kernels of ``csrc/batchnorm.cu``; on the CPU the same autograd functions run
each stage's plain version. These tests hold that op, through its plain
versions, to ``models/batchnorm.py``'s PyTorch composite followed by
``F.leaky_relu``: in float64 (against the composite's arithmetic restated in
float64) at rtol 1e-10, then at the channels-last parity tests' tolerances
against the composite itself, for the forward, the running statistics, the
first gradients of x, scale and bias and a penalty-style gradient of x's
gradient; ``gradcheck`` and ``gradgradcheck``; channels-last and contiguous
maps, with and without affine, LeakyReLU 0.2 and identity, a constant
channel (the variance's clamp) and row counts that are no power of 2. Then
the route: every input outside it keeps the composite's bits, the route
reads only the input, each call counts ``bn.layers`` (and
``bn.layers_kernel`` on the op), the DCGAN nets on the op agree with the
composite, and no kernel name falls into a benchmark category.

The test marked ``card`` needs CUDA and skips without it; on a machine with
a card it runs without this directory's conftest (which loads JAX), as
``python -m pytest tests/test_torch_port_bn_kernel.py -q --noconftest``.
"""

import re
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.core import trace  # noqa: E402
from rnagan_tpu_torch.core import profiling  # noqa: E402
from rnagan_tpu_torch.core.config import GANModelConfig  # noqa: E402
from rnagan_tpu_torch.kernels import _build  # noqa: E402
from rnagan_tpu_torch.kernels import batchnorm as kb  # noqa: E402
from rnagan_tpu_torch.models import batchnorm as mbn  # noqa: E402
from rnagan_tpu_torch.models import dcgan  # noqa: E402
from rnagan_tpu_torch.parallel import collectives  # noqa: E402

CL = torch.channels_last
#: (N, C, H, W): 105 and 18 rows, neither a power of 2
SHAPES = [(3, 8, 5, 7), (2, 16, 3, 3)]
SLOPES = {"leaky": 0.2, "identity": None}
#: the channels-last parity tests' tolerances (``test_torch_port_channels_last.py``), and one bf16 ulp at 1
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(profiling, "counters", {})
    return profiling.counters


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on the CPU: every tensor reads as a CUDA tensor, so
    ``takes_kernels`` decides by the rest of the input and the op runs its
    plain stages (they dispatch on the device, which stays the CPU)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)


def _inputs(shape, dtype, layout, affine, seed=0, constant=False):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 1.5 + 0.3)
    if constant:
        x[:, 2] = 0.75  # a constant channel: its sums are exact, E[x^2] - m^2 is 0
    x = x.to(dtype).contiguous(memory_format=layout)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    scale = torch.randn(c, generator=gen, dtype=pdt) * 0.3 + 1 if affine else None
    bias = torch.randn(c, generator=gen, dtype=pdt) * 0.2 if affine else None
    stats = (torch.randn(c, generator=gen, dtype=pdt), torch.rand(c, generator=gen, dtype=pdt) + 0.5)
    cot = torch.randn(shape, generator=gen, dtype=torch.float64)
    return x, scale, bias, stats, cot


def _composite(x, scale, bias, mean, var, slope):
    """``models/batchnorm.py``'s composite and LeakyReLU, as the CPU runs it."""
    return mbn.batch_norm(x, scale, bias, mean, var, train=True, leaky_slope=slope)


def _composite64(x, scale, bias, mean, var, slope):
    """The composite's arithmetic in float64 (its ``x.float()`` left out)."""
    axes = [0, 2, 3]
    xf = x.double()
    m = xf.mean(axes)
    v = torch.clamp((xf * xf).mean(axes) - m * m, min=0.0)
    new_mean, new_var = 0.9 * mean + 0.1 * m, 0.9 * var + 0.1 * v
    mul = torch.rsqrt(v + 1e-5)
    if scale is not None:
        mul = mul * scale
    y = (xf - m.reshape(1, -1, 1, 1)) * mul.reshape(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return y, new_mean.detach(), new_var.detach()


def _run(bn, x0, scale0, bias0, stats, cot, slope):
    """The output and running statistics, the first gradients of x, scale and
    bias, and the gradients of the penalty-style ``sum(dx^2)``."""
    x = x0.clone().requires_grad_(True)
    leaves = [x] + [t.clone().requires_grad_(True) for t in (scale0, bias0) if t is not None]
    scale, bias = (leaves[1], leaves[2]) if scale0 is not None else (None, None)
    y, new_mean, new_var = bn(x, scale, bias, *stats, slope)
    first = torch.autograd.grad((y.double() * cot).sum(), leaves, create_graph=True)
    twice = torch.autograd.grad((first[0].double() ** 2).sum(), leaves, allow_unused=True, materialize_grads=True)
    return [y, new_mean, new_var, *first, *twice]


def _names(affine):
    tail = ("x", "scale", "bias") if affine else ("x",)
    return ["y", "mean", "var", *(f"d{n}" for n in tail), *(f"dd{n}" for n in tail)]


def _close(got, want, names, **tol):
    for name, g, w in zip(names, got, want, strict=True):
        torch.testing.assert_close(g.double(), w.double(), **tol, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("act", list(SLOPES))
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("layout", [CL, torch.contiguous_format], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("shape", SHAPES, ids=["105_rows", "18_rows"])
def test_the_op_is_the_composite_in_float64(shape, layout, affine, act):
    """Every quantity at rtol 1e-10: only the order of the sums differs."""
    x, scale, bias, stats, cot = _inputs(shape, torch.float64, layout, affine)
    got = _run(kb.batch_norm_act, x, scale, bias, stats, cot, SLOPES[act])
    want = _run(_composite64, x, scale, bias, stats, cot, SLOPES[act])
    _close(got, want, _names(affine), rtol=1e-10, atol=1e-12)
    assert got[0].is_contiguous(memory_format=layout) and got[3].is_contiguous(memory_format=layout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("act", list(SLOPES))
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("layout", [CL, torch.contiguous_format], ids=["channels_last", "nchw"])
def test_the_op_is_the_composite_at_the_parity_tolerances(layout, affine, act, dtype):
    """Against ``models/batchnorm.py``'s composite itself on 105 rows:
    float32 at the channels-last parity tests' rtol 1e-5 / atol 1e-6 (the
    sums' order), bf16 maps within one bf16 ulp of the values' scale (the
    statistics' last bits can move a rounding of y, dx or dd*)."""
    x, scale, bias, stats, cot = _inputs(SHAPES[0], dtype, layout, affine, seed=1)
    got = _run(kb.batch_norm_act, x, scale, bias, stats, cot, SLOPES[act])
    want = _run(_composite, x, scale, bias, stats, cot, SLOPES[act])
    tol = TOL[dtype]
    for name, g, w in zip(_names(affine), got, want, strict=True):
        scale_of = w.double().abs().max().clamp_min(1.0)
        torch.testing.assert_close(g.double() / scale_of, w.double() / scale_of, **tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16], ids=["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("act", list(SLOPES))
def test_a_constant_channel(dtype, act):
    """A constant channel (0.75: exact sums, so ``E[x^2] - m^2`` is 0 in
    every dtype): its output is the bias, its batch variance 0, its running
    variance ``0.9 * old``, its x gradient ``mul * (g' - mean(g'))`` as the
    composite's, and the penalty's x gradient 0 there (the composite's
    float32 arithmetic leaves rounding of ``r^3`` there instead: its two
    terms ``2 x / R * dv`` and ``-2 m / R * dv`` cancel only in exact
    arithmetic); every other channel as in the tests above."""
    x, scale, bias, stats, cot = _inputs(SHAPES[0], dtype, CL, True, seed=2, constant=True)
    slope = SLOPES[act]
    got = _run(kb.batch_norm_act, x, scale, bias, stats, cot, slope)
    act_fn = (lambda t: t) if slope is None else (lambda t: F.leaky_relu(t, slope))
    torch.testing.assert_close(got[0][:, 2].double(), act_fn(bias[2].to(dtype)).double().expand(3, 5, 7),
                               rtol=0, atol=0)
    assert float(got[2][2]) == pytest.approx(0.9 * float(stats[1][2]), rel=1e-6)
    want = _run(_composite64 if dtype == torch.float64 else _composite, x, scale, bias, stats, cot, slope)
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == torch.float64 else TOL[dtype]
    for name, g, w in zip(_names(True)[:6], got[:6], want[:6], strict=True):
        scale_of = w.double().abs().max().clamp_min(1.0)
        torch.testing.assert_close(g.double() / scale_of, w.double() / scale_of, **tol,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert torch.count_nonzero(got[6][:, 2]) == 0
    others = [c for c in range(x.shape[1]) if c != 2]
    for name, g, w in zip(_names(True)[6:], got[6:], want[6:], strict=True):
        if name == "ddx":
            g, w = g[:, others], w[:, others]
        elif dtype != torch.float64:
            continue  # the composite's scale and bias gradients carry the constant channel's rounding too
        scale_of = w.double().abs().max().clamp_min(1.0)
        torch.testing.assert_close(g.double() / scale_of, w.double() / scale_of, **tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("act", list(SLOPES))
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("layout", [CL, torch.contiguous_format], ids=["channels_last", "nchw"])
def test_gradcheck_and_gradgradcheck(layout, affine, act):
    """The op's first and second derivatives against finite differences in
    float64 on 18 rows; the first also with a constant channel (the clamp
    sits at its kink there, where a second difference is not defined), where
    a bias or no activation keeps that channel's z = bias off LeakyReLU's kink."""
    slope = SLOPES[act]
    for constant in (False, True) if affine or slope is None else (False,):
        x, scale, bias, stats, _ = _inputs(SHAPES[1], torch.float64, layout, affine, seed=3, constant=constant)
        leaves = [t.requires_grad_(True) for t in (x, scale, bias) if t is not None]

        def fn(*ts):
            s, b = (ts[1], ts[2]) if affine else (None, None)
            return kb.batch_norm_act(ts[0], s, b, *stats, slope)[0]

        assert torch.autograd.gradcheck(fn, leaves)
        if not constant:
            assert torch.autograd.gradgradcheck(fn, leaves)


def _batch_norm_as_before(x, scale, bias, mean, var, *, train, leaky_slope=None):
    """``batchnorm.batch_norm``'s one-device composite as it was, then ``F.leaky_relu``."""
    axes = [0, *range(2, x.ndim)]
    xf = x.float()
    if train:
        m = xf.mean(axes)
        v = torch.clamp((xf * xf).mean(axes) - m * m, min=0.0)
        new_mean = (0.9 * mean + 0.1 * m).detach()
        new_var = (0.9 * var + 0.1 * v).detach()
    else:
        m, v, new_mean, new_var = mean, var, mean, var
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(v + 1e-5) * scale
    y = ((xf - m.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)).to(x.dtype)
    if leaky_slope is not None:
        y = F.leaky_relu(y, leaky_slope)
    return y, new_mean, new_var


#: inputs outside the kernel route: name -> (shape, dtype, memory format, train)
OUTSIDE = {"cpu": ((3, 8, 5, 7), torch.bfloat16, CL, True), "2d": ((6, 8), torch.bfloat16, None, True),
           "nchw": ((3, 8, 5, 7), torch.bfloat16, torch.contiguous_format, True),
           "float32": ((3, 8, 5, 7), torch.float32, CL, True), "eval": ((3, 8, 5, 7), torch.bfloat16, CL, False),
           "channels_not_8": ((3, 12, 5, 7), torch.bfloat16, CL, True)}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_inputs_outside_the_route_keep_the_composite_bits(case, counters):
    """``batch_norm`` with the fused LeakyReLU on every input the route
    leaves out, against the composite as it was and ``F.leaky_relu`` at
    rtol = atol = 0 in every derivative; nothing counted on the CPU."""
    shape, dtype, layout, train = OUTSIDE[case]
    gen = torch.Generator().manual_seed(7)
    x0 = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    if layout is not None:
        x0 = x0.contiguous(memory_format=layout)
    c = shape[1]
    scale0, bias0 = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    stats = (torch.randn(c, generator=gen), torch.rand(c, generator=gen) + 0.5)
    cot = torch.randn(shape, generator=gen).to(dtype)
    assert not mbn.takes_kernels(x0, train)

    def run(bn):
        x = x0.clone().requires_grad_(True)
        scale, bias = scale0.clone().requires_grad_(True), bias0.clone().requires_grad_(True)
        y, new_mean, new_var = bn(x, scale, bias, *stats, train=train, leaky_slope=0.2)
        gx, gs, gb = torch.autograd.grad((y.float() * cot.float()).sum(), (x, scale, bias), create_graph=True)
        twice = torch.autograd.grad((gx.float() * gx.float()).sum(), (x, scale, bias), allow_unused=True,
                                    materialize_grads=True)
        return y, new_mean, new_var, gx, gs, gb, *twice

    for name, g, r in zip(("y", "mean", "var", "dx", "dscale", "dbias", "ddx", "ddscale", "ddbias"),
                          run(mbn.batch_norm), run(_batch_norm_as_before), strict=True):
        torch.testing.assert_close(g, r, rtol=0, atol=0, msg=lambda m, name=name: f"{name}: {m}")
    assert counters == {}


def _route_case(case):
    gen = torch.Generator().manual_seed(0)
    shape = {"2d": (6, 16), "channels_not_8": (2, 12, 3, 3)}.get(case, (2, 16, 3, 3))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x = torch.randn(shape, generator=gen).to(dtype)
    if case == "misaligned":
        x = torch.randn(2 * 16 * 9 + 1, generator=gen).to(dtype)[1:].reshape(2, 3, 3, 16).permute(0, 3, 1, 2)
    elif case != "nchw" and x.ndim == 4:
        x = x.contiguous(memory_format=CL)
    return x


@pytest.mark.parametrize("case,takes", [("kernel", True), ("2d", False), ("nchw", False), ("float32", False),
                                        ("eval", False), ("channels_not_8", False), ("misaligned", False),
                                        ("data_group", False)])
def test_the_route_reads_the_input(case, takes, card_route, monkeypatch):
    """With every tensor reading as a CUDA tensor: the op takes a train-mode
    bf16 channels-last map with C % 8 == 0, 16-byte aligned, outside a mesh,
    and nothing else."""
    x = _route_case(case)
    if case == "data_group":
        monkeypatch.setattr(collectives, "data_group", lambda: object())
    assert mbn.takes_kernels(x, case != "eval") is takes


@pytest.mark.parametrize("case,counted", [("kernel", {"bn.layers": 1, "bn.layers_kernel": 1}),
                                          ("nchw", {"bn.layers": 1}), ("eval", {})])
def test_each_call_counts_its_route(case, counted, card_route, counters):
    """``bn.layers`` for each train-mode call on a CUDA map, ``bn.layers_kernel`` for one on the op."""
    x = _route_case(case)
    c = x.shape[1]
    y, _, _ = mbn.batch_norm(x, torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c),
                             train=case != "eval", leaky_slope=0.2)
    assert counters == counted
    assert y.shape == x.shape


@pytest.mark.parametrize("arch", ["dcgan", "condgan", "dcgan_up"])
def test_the_dcgan_nets_on_the_op(arch, card_route, counters):
    """The DCGAN nets in bf16 train mode on the op (the card's route, run by
    the plain stages) against the same nets on the composite: G's images, D's
    scores and the running statistics within bf16's tolerance, and every
    BatchNorm of both nets counted on the op."""
    cfg = GANModelConfig(arch=arch, out_size=32, encoding_dims=16, step_channels=8, compute_dtype="bfloat16",
                         num_classes=3 if arch == "condgan" else 0)
    g_cls, d_cls = {"dcgan": (dcgan.DCGANGenerator, dcgan.DCGANDiscriminator),
                    "condgan": (dcgan.ConditionalDCGANGenerator, dcgan.ConditionalDCGANDiscriminator),
                    "dcgan_up": (dcgan.DCGANUpGenerator, dcgan.DCGANDiscriminator)}[arch]
    g, d = g_cls(cfg, seed=1), d_cls(cfg, seed=2)
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([0, 1, 2, 0]) if arch == "condgan" else None

    def step():
        img, g_new = g.forward_stats(z, g.bn_stats(), True, labels=labels)
        score, d_new = d(img, d.bn_stats(), True, labels=labels)
        return [img, score, *(t for pair in g_new + d_new for t in pair)]

    got = step()
    assert counters["bn.layers"] == counters["bn.layers_kernel"] == len(g.bn_stats()) + len(d.bn_stats())
    orig = mbn.takes_kernels
    mbn.takes_kernels = lambda x, train: False
    try:
        want = step()
    finally:
        mbn.takes_kernels = orig
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        scale_of = b.double().abs().max().clamp_min(1.0)
        torch.testing.assert_close(a.double() / scale_of, b.double() / scale_of, rtol=2 ** -6, atol=2 ** -6,
                                   msg=lambda m, i=i: f"output {i}: {m}")


@pytest.mark.parametrize("rows,channels", [(128, 2048), (512, 1024), (2048, 512), (8192, 256), (32768, 128),
                                           (131072, 64), (524288, 64), (105, 8), (18, 2056), (5, 16)])
def test_the_launch_plan_covers_every_row(rows, channels):
    """Each launch's chunks cover the rows with none empty, and a statistics
    launch leaves each tile's last block at most ``MAX_PARTIALS`` sums of a kind."""
    for sums in (True, False):
        chunks, per = kb.plan(rows, channels, sums)
        assert chunks >= 1 and chunks * per >= rows > (chunks - 1) * per
        if sums:
            assert chunks * min(channels, kb.TILE_GROUPS * kb.VEC) <= kb.MAX_PARTIALS


def test_kernel_names_stay_out_of_the_benchmark_categories():
    """The six kernels fall into the benchmark's "elementwise and other"
    (``perfbench/core/trace.py``'s ``CATEGORIES``), match no ``COUNTED``
    pattern and are no stage mark, so no by-name metric reads them."""
    text = (_build.CSRC / "batchnorm.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n(\w+)\(", text)
    assert names == ["rnagan_bn_stats", "rnagan_bn_apply", "rnagan_bn_grad_sums", "rnagan_bn_grad_input",
                     "rnagan_bn_grad2_sums", "rnagan_bn_grad2_input"]
    for name in names:
        assert trace.category(name) == "elementwise and other", name
        assert not any(pattern in name for pattern in trace.COUNTED)
        assert not name.startswith(profiling.MARK_PREFIX)


def test_the_kernel_constants_match_the_wrapper():
    """``plan`` sizes the grid and the scratch from the kernels' own constants."""
    text = (_build.CSRC / "batchnorm.cu").read_text()

    def constant(name, kind="int"):
        return re.search(rf"constexpr {kind} {name} = ([\d.e-]+)f?;", text).group(1)

    assert int(constant("kThreads")) == kb.THREADS and int(constant("kVec")) == kb.VEC
    assert int(constant("kTileGroups")) == kb.TILE_GROUPS and int(constant("kUnroll")) == kb.UNROLL
    assert int(constant("kGrad2Coefs")) == kb.GRAD2_COEFS
    assert float(constant("kEps", "float")) == kb.EPS and float(constant("kMomentum", "float")) == kb.MOMENTUM
    assert mbn.EPS == kb.EPS and mbn.MOMENTUM == kb.MOMENTUM


def test_the_op_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="N, C, H, W"):
        kb.batch_norm_act(torch.zeros(4, 8), None, None, torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kb.batch_norm_act(torch.zeros(2, 8, 2, 2, device="meta"), None, None, torch.zeros(8, device="meta"),
                          torch.ones(8, device="meta"))


# ----------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test launches the BatchNorm kernels")
    return torch.device("cuda", 0)


#: (N, C, H, W) of the card checks: DCGAN's G and D maps at batch 8 (the head's and the widest), the
#: quality run's widest at batch 32, the published BigGAN's widest
CARD_SHAPES = [(8, 2048, 4, 4), (8, 512, 16, 16), (8, 128, 64, 64), (8, 64, 128, 128), (32, 64, 128, 128),
               (8, 64, 256, 256)]


def _card_inputs(card, shape, affine, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=card) * 1.5 + 0.3).to(torch.bfloat16).contiguous(memory_format=CL)
    scale = torch.randn(c, generator=gen, device=card) * 0.2 + 1 if affine else None
    bias = torch.randn(c, generator=gen, device=card) * 0.1 if affine else None
    stats = (torch.randn(c, generator=gen, device=card), torch.rand(c, generator=gen, device=card) + 0.5)
    cot = torch.randn(shape, generator=gen, device=card, dtype=torch.float64).contiguous(memory_format=CL)
    return x, scale, bias, stats, cot


def _share_of_max(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.card
@pytest.mark.parametrize("affine,act", [(True, "leaky"), (False, "identity"), (True, "identity")],
                         ids=["dcgan", "ccbn", "output_bn"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_kernels_on_the_card(card, shape, affine, act):
    """Each stage against its plain version on one input: the statistics and
    the backward's sums within 1e-5 of their largest value (float32 sums in
    another order), y bit-equal (the same rounded operations from the same
    statistics), dx and the double backward's two maps within half a bf16
    ulp of their largest value (FMA contraction), the double backward's
    coefficients and scale gradient within 1e-5 (float32 sums again); two
    launches bit-equal. The op against the composite,
    forward, first backward and the penalty's double backward, within 2^-6
    of each tensor's largest value: the statistics' last float32 bits move
    some bf16 roundings by one ulp."""
    slope = SLOPES[act]
    x, scale, bias, stats, cot = _card_inputs(card, shape, affine, seed=sum(shape))
    rows = kb.rows_of(x)
    st, nm, nv = kb._stats(rows, scale, *stats)
    st_p, nm_p, nv_p = kb.stats_plain(rows, scale, *stats)
    g = cot.to(torch.bfloat16)
    g_rows = kb.rows_of(g)
    db, ds = kb._grad_sums(g_rows, rows, st, bias, slope)
    db_p, ds_p = kb.grad_sums_plain(g_rows, rows, st, bias, slope)
    for name, a, b in (("m", st[0], st_p[0]), ("rstd", st[1], st_p[1]), ("mul", st[2], st_p[2]),
                       ("new_mean", nm, nm_p), ("new_var", nv, nv_p), ("dbias", db, db_p), ("dscale", ds, ds_p)):
        assert _share_of_max(a, b) <= 1e-5, name
    assert torch.equal(kb._apply(rows, st, bias, slope), kb.apply_plain(rows, st, bias, slope))
    dx = kb._grad_input(g_rows, rows, st, bias, slope, db, ds)
    assert _share_of_max(dx, kb.grad_input_plain(g_rows, rows, st, bias, slope, db, ds)) <= 2 ** -8
    u = kb.rows_of(torch.flip(g, (0,)).contiguous(memory_format=CL))
    a2, b2 = db.flip(0).contiguous(), ds.flip(0).contiguous()
    coef, gs = kb._grad2_sums(g_rows, rows, u, st, bias, slope, db, ds, a2, b2)
    coef_p, gs_p = kb.grad2_sums_plain(g_rows, rows, u, st, bias, slope, db, ds, a2, b2)
    assert _share_of_max(coef, coef_p) <= 1e-5 and _share_of_max(gs, gs_p) <= 1e-5
    for a, b in zip(kb._grad2_input(g_rows, rows, u, st, bias, slope, coef),
                    kb.grad2_input_plain(g_rows, rows, u, st, bias, slope, coef)):
        assert _share_of_max(a, b) <= 2 ** -8
    assert torch.equal(kb._stats(rows, scale, *stats)[0], st)
    assert all(torch.equal(a, b) for a, b in zip(kb._grad_sums(g_rows, rows, st, bias, slope), (db, ds)))

    def composite(*args):
        takes, mbn.takes_kernels = mbn.takes_kernels, lambda x, train: False
        try:
            return _composite(*args)
        finally:
            mbn.takes_kernels = takes

    got = _run(kb.batch_norm_act, x, scale, bias, stats, cot, slope)
    want = _run(composite, x, scale, bias, stats, cot, slope)
    for name, a, b in zip(_names(affine), got, want, strict=True):
        assert _share_of_max(a, b) <= 2 ** -6, name


@pytest.mark.card
def test_replays_are_bit_stable_and_the_names_stay_out_of_the_categories(card):
    """Two replays of a captured forward, backward and double backward at D's
    widest map equal each other and the eager run bit for bit (the sums have
    one order; no float atomics), and the profiled kernels are the six of
    ``csrc/batchnorm.cu``, none in a benchmark category or counted pattern."""
    from torch.profiler import ProfilerActivity, profile

    x, scale, bias, stats, cot = _card_inputs(card, (8, 128, 64, 64), True, seed=1)
    outs = []

    def body():
        outs[:] = _run(kb.batch_norm_act, x, scale, bias, stats, cot, 0.2)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.detach().clone() for t in outs])
    eager = _run(kb.batch_norm_act, x, scale, bias, stats, cot, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(*replays))
    assert all(torch.equal(a, b.detach()) for a, b in zip(replays[0], eager))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(kb.batch_norm_act, x, scale, bias, stats, cot, 0.2)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "rnagan_bn_" in e.key}
    assert len(names) == 6
    for name in names:
        assert trace.category(name) == "elementwise and other" and not any(p in name for p in trace.COUNTED)


@pytest.mark.card
def test_launches_on_two_streams_at_once_keep_their_own_sums(card):
    """The three summing kernels on two streams at once, another map on
    each, 20 times over: every launch's results equal those of the same
    launch alone bit for bit (a launch counts its blocks' arrivals on
    tickets of its own)."""
    inputs = [_card_inputs(card, shape, True, seed) for seed, shape in ((2, (8, 128, 64, 64)), (3, (8, 256, 32, 32)))]

    def sums(x, scale, bias, stats, cot):
        rows, g = kb.rows_of(x), kb.rows_of(cot.to(torch.bfloat16))
        st, new_mean, new_var = kb._stats(rows, scale, *stats)
        dbias, dscale = kb._grad_sums(g, rows, st, bias, 0.2)
        coef, dscale_grad = kb._grad2_sums(g, rows, g, st, bias, 0.2, dbias, dscale, None, None)
        return [st, new_mean, new_var, dbias, dscale, coef, dscale_grad]

    alone = [sums(*args) for args in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    runs = [[], []]
    for _ in range(20):
        for k, (s, args) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                runs[k].append(sums(*args))
    torch.cuda.synchronize()
    for k in range(2):
        for got in runs[k]:
            assert all(torch.equal(a, b) for a, b in zip(got, alone[k], strict=True))


@pytest.mark.card
@pytest.mark.parametrize("arch", ["dcgan", "dcgan_up", "condgan", "biggan_pub"])
def test_a_captured_bf16_step_is_the_eager_step(card, arch, counters):
    """A small bf16 ``wganvae`` configuration of each net on the BatchNorm
    kernels: 3 captured steps (``train_step``) against the same 3 eager
    (``train_step_eager``) from copies of one state, cuDNN deterministic:
    parameters, statistics, moments and metrics bit-equal; every DCGAN
    BatchNorm call on the kernels (BigGAN's counted as they fall)."""
    import copy

    from rnagan_tpu_torch.core.config import GANConfig, VAEModelConfig
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    extra = {"condgan": {"num_classes": 3},
             "biggan_pub": {"num_classes": 2, "embed_dim": 16, "attn_size": 16}}.get(arch, {})
    cfg = GANConfig(model=GANModelConfig(arch=arch, out_size=32, encoding_dims=64, step_channels=8,
                                         compute_dtype="bfloat16", **extra),
                    vae=VAEModelConfig(rna_features=256, z_dim=64, encoder_dims=(128, 96, 64), decoder_dims=(96, 128)))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr = GANTrainer(cfg, BetaVAE(cfg.vae, seed=3, device=card).state_dict(), device=card)
        assert tr.captures()
        s0 = tr.init_state()
        gen = torch.Generator(device=card).manual_seed(9)
        batches = []
        for _ in range(3):
            b = {"image": torch.randint(0, 256, (cfg.batch_size, 32, 32, 3), generator=gen, device=card,
                                        dtype=torch.uint8),
                 "rna_data": torch.randn(cfg.batch_size, 256, generator=gen, device=card)}
            if cfg.model.num_classes:
                b["labels"] = torch.randint(0, cfg.model.num_classes, (cfg.batch_size,), generator=gen, device=card)
            batches.append(b)
        tr.train_step_eager(copy.deepcopy(s0), batches[0])  # cuDNN's first calls
        cap, eag = copy.deepcopy(s0), copy.deepcopy(s0)
        counters.clear()
        m_cap = [tr.train_step(cap, b)[1] for b in batches]
        m_eag = [tr.train_step_eager(eag, b)[1] for b in batches]
    finally:
        torch.backends.cudnn.deterministic = prev
    for a, b in zip(m_cap, m_eag):
        assert all(torch.equal(a[k], b[k]) for k in a)
    pairs = [(p, q) for x, y in ((cap.generator, eag.generator), (cap.discriminator, eag.discriminator))
             for p, q in zip(x.parameters(), y.parameters())]
    pairs += [(u, w) for s, t in ((cap.g_stats, eag.g_stats), (cap.d_stats, eag.d_stats))
              for a, b in zip(s, t) for u, w in zip(a, b)]
    pairs += [(u, w) for o, q in ((cap.g_opt, eag.g_opt), (cap.d_opt, eag.d_opt))
              for u, w in zip(o.mu + o.nu, q.mu + q.nu)]
    assert all(torch.equal(p, q) for p, q in pairs)
    assert counters["bn.layers_kernel"] > 0
    if arch != "biggan_pub":
        assert counters["bn.layers_kernel"] == counters["bn.layers"]
