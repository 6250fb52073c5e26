"""The GAN nets' channels-last convolutions (``models/dcgan.py``,
``models/biggan_pub.py``), on the CPU.

On a CUDA card the ``dcgan``, ``condgan``, ``dcgan_up`` and ``biggan_pub``
nets convolve channels-last operands; on the CPU they keep contiguous NCHW
(``dcgan.conv_layout``, keyed on the input's device). These tests put the CPU
on the card's path by patching ``conv_layout`` and hold it, at float32, to a
plain NCHW reference written here with ``torch.nn.functional`` from the same
weights (for ``biggan_pub``, the benchmark's plain reference
``perfbench/reference/biggan.py``): the forwards at 1e-5, and one ``train_step_eager`` with the
reference nets in the trainer's step at the parity tests' tolerances
(metrics rtol 1e-4, parameters rtol 1e-6 / atol 1e-7, Adam moments rtol 1e-4
plus 1e-5 of each tensor's largest value, statistics rtol 1e-5 / atol 1e-6),
from a state whose weights make activations O(1) and whose Adam ``nu`` is far
above ``(1-b2)*g^2``. The gradients that reach Adam, the masters and the
moments stay contiguous, eval-mode images come back contiguous NCHW, every
convolution of the step counts as channels-last, SAGAN and the port's BigGAN keep
their NCHW path and leave the counters alone, and ``batch_norm`` keeps the
bits of ``Tensor.mean`` and ``xf - m`` in every derivative it is taken to.

The test marked ``card`` needs CUDA and skips without it; on a machine with a
card it runs without this directory's conftest (which loads JAX), as
``python -m pytest tests/test_torch_port_channels_last.py -q --noconftest``.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.reference import biggan as ref_biggan  # noqa: E402
from rnagan_tpu_torch.core import profiling  # noqa: E402
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig  # noqa: E402
from rnagan_tpu_torch.losses import gan as gan_losses  # noqa: E402
from rnagan_tpu_torch.models import dcgan  # noqa: E402
from rnagan_tpu_torch.models.betavae import BetaVAE  # noqa: E402
from rnagan_tpu_torch.optim.adam import Adam  # noqa: E402
from rnagan_tpu_torch.train.gan_trainer import GANTrainer  # noqa: E402

N = 2  # batch: no channel count of these nets, so a batch map is told apart by its first size
VAE_MODEL = VAEModelConfig(rna_features=12, z_dim=8, encoder_dims=(10, 8), decoder_dims=(10,),
                           compute_dtype="float32")
MODEL = dict(out_size=16, encoding_dims=8, step_channels=4, compute_dtype="float32")
ARCHS = {"dcgan": {}, "condgan": {"num_classes": 3}, "dcgan_up": {},
         "biggan_pub": {"out_size": 64, "attn_size": 32, "num_classes": 2, "embed_dim": 4, "step_channels": 16}}
CL = torch.channels_last


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def channels_last(monkeypatch):
    """The card's layout on the CPU."""
    monkeypatch.setattr(dcgan, "conv_layout", lambda x: CL)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(profiling, "counters", {})
    return profiling.counters


def _cfg(arch, **model_kw):
    return GANConfig(model=GANModelConfig(arch=arch, **{**MODEL, **ARCHS.get(arch, {})}, **model_kw),
                     vae=VAE_MODEL, batch_size=N)


def _labels(cfg):
    return torch.arange(N) % cfg.model.num_classes if cfg.model.num_classes else None


def _trainer(cfg):
    return GANTrainer(cfg, vae_state_dict=BetaVAE(VAE_MODEL, seed=3).state_dict(), device="cpu")


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    size = cfg.model.out_size
    batch = {"image": rs.randint(0, 256, (N, size, size, cfg.model.out_channels)).astype(np.uint8),
             "rna_data": rs.randn(N, VAE_MODEL.rna_features).astype(np.float32)}
    if cfg.model.num_classes:
        batch["labels"] = np.arange(N) % cfg.model.num_classes
    return batch


def _draws(cfg, seed=1):
    rs = np.random.RandomState(seed)
    r, shape = cfg.noise_range, (N, cfg.model.encoding_dims)
    u_d, u_gp, u_g = (rs.uniform(-r, r, shape).astype(np.float32) for _ in range(3))
    return {"u_d": u_d, "u_gp": u_gp, "u_g": u_g, "eps": rs.rand(N, 1, 1, 1).astype(np.float32)}


@torch.no_grad()
def _scale(state, seed=5):
    """Weights that keep activations O(1), Adam at counts 5 (G) and 7 (D)
    with ``nu`` far above ``(1-b2)*g^2`` (the parity tests' step-5 state)."""
    gen = torch.Generator().manual_seed(seed)
    for net in (state.generator, state.discriminator):
        for name, p in net.named_parameters():
            if name.endswith(".1.weight"):  # BatchNorm scale
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.ndim == 4:
                fan_in = p.shape[0 if "Transpose" in type(_module(net, name)).__name__ else 1] * p[0, 0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
            elif p.ndim == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    for opt, count in ((state.g_opt, 5), (state.d_opt, 7)):
        opt.count = count
        for mu, nu in zip(opt.mu, opt.nu):
            mu.copy_(1e-3 * torch.randn(mu.shape, generator=gen))
            nu.copy_((torch.rand(nu.shape, generator=gen) + 0.5) * 1e-2)
    state.step = 5
    return state


def _module(net, param_name):
    return net.get_submodule(param_name.rsplit(".", 1)[0])


def _convs(net):
    return sum(1 for m in net.modules() if isinstance(m, nn.modules.conv._ConvNd))


# ---------------------------------------------------------------- reference


def _ref_bn(x, scale, bias, mean, var, train):
    """flax's BatchNorm (``models/batchnorm.py``) in plain ops: biased batch
    variance, running statistics 0.9 old + 0.1 batch."""
    if train:
        m = x.mean((0, 2, 3))
        v = torch.clamp((x * x).mean((0, 2, 3)) - m * m, min=0.0)
        new = ((0.9 * mean + 0.1 * m).detach(), (0.9 * var + 0.1 * v).detach())
    else:
        m, v, new = mean, var, (mean, var)
    y = (x - m[None, :, None, None]) * (torch.rsqrt(v + 1e-5) * scale)[None, :, None, None]
    return y + bias[None, :, None, None], new


def _onehot_maps(x, labels, k):
    oh = F.one_hot(labels.long(), k).to(x.dtype)
    return torch.cat([x, oh[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3])], 1)


def _published(net, stats, params, train, forward):
    """``forward(p, state, m)`` of ``perfbench/reference/biggan.py`` on a
    ``biggan_pub`` net's parameters (or ``params`` in their place) and its
    state list, and the new state as that list: a BatchNorm's statistics,
    a spectral norm's ``u`` and, in train mode, the ``sigma`` of
    ``layers.SN``'s power iteration."""
    p = dict(net.named_parameters())
    if params is not None:
        p = dict(zip(p, params, strict=True))
    names = {id(t): n for n, t in net.named_buffers()}
    slots = [names[id(a)].rsplit(".", 1) for a, _ in net.bn_stats()]  # (prefix, "running_mean" or "sn_u")
    state = {}
    for (prefix, leaf), (a, b) in zip(slots, stats, strict=True):
        state[f"{prefix}.{leaf}"] = a
        if leaf == "running_mean":
            state[f"{prefix}.running_var"] = b
    m = {k: getattr(net.cfg, k) for k in ("out_size", "attn_size", "step_channels", "out_channels",
                                          "encoding_dims", "num_classes", "embed_dim")}
    out, new = forward(p, state, m)
    new_stats = []
    for (prefix, leaf), (a, b) in zip(slots, stats, strict=True):
        if leaf == "running_mean":
            new_stats.append((new[f"{prefix}.running_mean"], new[f"{prefix}.running_var"]))
        elif not train:
            new_stats.append((a, b))
        else:
            u = new[f"{prefix}.sn_u"]
            w = p[f"{prefix}.weight"].detach()
            mat = w.reshape(w.shape[0], -1)
            v = F.normalize(a @ mat, eps=1e-12)
            new_stats.append((u, ((v @ mat.t()) @ u.t())[0, 0]))
    return out, new_stats


def ref_generator(net, z, stats, train, params=None, labels=None):
    """A generator's ``forward_stats`` in float32 NCHW, from its weights
    (``biggan_pub``'s: the benchmark's plain reference)."""
    cfg = net.cfg
    if cfg.arch == "biggan_pub":
        return _published(net, stats, params, train,
                          lambda p, state, m: ref_biggan.generator(p, state, z, labels.long(), train, m))
    p = dict(net.named_parameters())
    if params is not None:
        p = dict(zip(p, params))
    if net.conditional:
        z = torch.cat([z, F.one_hot(labels.long(), cfg.num_classes).to(z.dtype)], 1)
    x, new, last = z[:, :, None, None], [], len(net.model) - 1
    for i, block in enumerate(net.model):
        conv, w, b = block[0], p[f"model.{i}.0.weight"], p.get(f"model.{i}.0.bias")
        if isinstance(conv, nn.ConvTranspose2d):
            x = F.conv_transpose2d(x, w, b, conv.stride, conv.padding)
        else:
            up = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = F.conv2d(F.pad(up, (1, 1, 1, 1), mode="reflect"), w, b)
        if i == last:
            break
        x, s = _ref_bn(x, p[f"model.{i}.1.weight"], p[f"model.{i}.1.bias"], *stats[i], train)
        new.append(s)
        x = F.leaky_relu(x, cfg.leaky_slope)
    tanh = getattr(net, "final_tanh", True) and not getattr(net, "compat_no_tanh", False)
    return (torch.tanh(x) if tanh else x), new


def ref_discriminator(net, x, stats, train, cond=None, labels=None):
    """A discriminator's ``forward`` (DCGAN's unconditional critic) in float32 NCHW, from its weights
    (``biggan_pub``'s: the benchmark's plain reference)."""
    cfg = net.cfg
    if cfg.arch == "biggan_pub":
        return _published(net, stats, None, train,
                          lambda p, state, m: ref_biggan.discriminator(p, state, x, labels.long(), train, m))
    p = dict(net.named_parameters())
    if net.conditional:
        x = _onehot_maps(x, labels, cfg.num_classes)
    new, last = [], len(net.model) - 1
    for i, block in enumerate(net.model):
        conv = block[0]
        x = F.conv2d(x, p[f"model.{i}.0.weight"], p.get(f"model.{i}.0.bias"), conv.stride, conv.padding)
        if i == last:
            break
        if i > 0:
            x, s = _ref_bn(x, p[f"model.{i}.1.weight"], p[f"model.{i}.1.bias"], *stats[i - 1], train)
            new.append(s)
        x = F.leaky_relu(x, cfg.leaky_slope)
    return F.leaky_relu(x.reshape(x.shape[0]), cfg.leaky_slope), new


class _RefG(nn.Module):
    """The trainer's generator, computed by :func:`ref_generator` on the port net's own parameters."""

    def __init__(self, net):
        super().__init__()
        self.net, self.cfg = net, net.cfg

    def forward_stats(self, z, stats, train, params=None, labels=None):
        return ref_generator(self.net, z, stats, train, params, labels)


class _RefD(nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net, self.cfg = net, net.cfg

    def forward(self, x, stats, train, cond=None, labels=None):
        return ref_discriminator(self.net, x, stats, train, cond, labels)


def _close(got, want, rtol, atol, scaled=0.0, what=""):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = w.detach().float()
        torch.testing.assert_close(g.detach().float(), w, rtol=rtol, atol=atol + scaled * float(w.abs().max()),
                                   msg=lambda m: f"{what} {i}: {m}")


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forwards_match_the_nchw_reference(channels_last, counters, arch, train):
    cfg = _cfg(arch)
    tr = _trainer(cfg)
    st = _scale(tr.init_state())
    G, D = st.generator, st.discriminator
    gen = torch.Generator().manual_seed(2)
    z = torch.rand((N, cfg.model.encoding_dims), generator=gen) - 0.5
    labels = _labels(cfg)
    img, g_new = G.forward_stats(z, st.g_stats, train, labels=labels)
    size = cfg.model.out_size
    x = torch.rand((N, 3, size, size), generator=gen) * 2 - 1
    score, d_new = D(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), st.d_stats, train, labels=labels)
    assert counters["gan.convs_channels_last"] == counters["gan.convs"] == _convs(G) + _convs(D)
    ref_img, ref_g_new = ref_generator(G, z, st.g_stats, train, labels=labels)
    _close([img], [ref_img], rtol=0, atol=1e-5, what="G")
    _close([t for pair in g_new for t in pair], [t for pair in ref_g_new for t in pair], rtol=1e-5, atol=1e-6)
    assert img.is_contiguous(memory_format=CL if train else torch.contiguous_format)
    ref_score, ref_d_new = ref_discriminator(D, x, st.d_stats, train, labels=labels)
    _close([score], [ref_score], rtol=0, atol=1e-5, what="D")
    _close([t for pair in d_new for t in pair], [t for pair in ref_d_new for t in pair], rtol=1e-5, atol=1e-6)


@torch.no_grad()
def _state_copy(trainer, state, ref=False):
    copy = trainer.init_state()
    for dst, src in zip(trainer._state_tensors(copy), trainer._state_tensors(state), strict=True):
        dst.copy_(src)
    copy.step, copy.g_opt.count, copy.d_opt.count = state.step, state.g_opt.count, state.d_opt.count
    if ref:
        copy.generator, copy.discriminator = _RefG(copy.generator), _RefD(copy.discriminator)
    return copy


@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_train_step_matches_the_nchw_reference_step(channels_last, counters, monkeypatch, arch):
    """One ``train_step_eager`` (wganvae, the fused GP, the G stage) on the
    channels-last nets against the same step on the reference nets: metrics,
    parameters, statistics and Adam moments. Every gradient that reaches
    Adam, every master and every moment is contiguous."""
    cfg = _cfg(arch)
    tr = _trainer(cfg)
    st = _scale(tr.init_state())
    ref = _state_copy(tr, st, ref=True)
    seen = []
    step = Adam.step

    def recording_step(self, params, grads, **kw):
        seen.extend((g.dtype, g.is_contiguous()) for g in grads)
        return step(self, params, grads, **kw)

    monkeypatch.setattr(Adam, "step", recording_step)
    _, met = tr.train_step_eager(st, _batch(cfg), _draws(cfg))
    assert seen and set(seen) == {(torch.float32, True)}
    assert counters["gan.convs_channels_last"] == counters["gan.convs"] > 0
    _, ref_met = tr.train_step_eager(ref, _batch(cfg), _draws(cfg))
    for name in ref_met:
        _close([met[name]], [ref_met[name]], rtol=1e-4, atol=1e-7, what=name)
    assert st.step == ref.step and st.g_opt.count == ref.g_opt.count and st.d_opt.count == ref.d_opt.count
    for got, want in ((st.generator, ref.generator.net), (st.discriminator, ref.discriminator.net)):
        _close(list(got.parameters()), list(want.parameters()), rtol=1e-6, atol=1e-7, what="param")
    _close([t for pair in st.g_stats + st.d_stats for t in pair],
           [t for pair in ref.g_stats + ref.d_stats for t in pair], rtol=1e-5, atol=1e-6, what="stats")
    for opt, ref_opt in ((st.g_opt, ref.g_opt), (st.d_opt, ref.d_opt)):
        _close(opt.mu, ref_opt.mu, rtol=1e-4, atol=1e-7, scaled=1e-5, what="mu")
        _close(opt.nu, ref_opt.nu, rtol=1e-4, atol=1e-9, scaled=1e-5, what="nu")
    for t in tr._state_tensors(st):
        assert t.is_contiguous()


@pytest.mark.parametrize("arch", ["dcgan", "biggan_pub"])
def test_sampling_and_eval_hand_back_contiguous_nchw(channels_last, arch):
    cfg = _cfg(arch)
    tr = _trainer(cfg)
    st = tr.init_state()
    tr.train_step_eager(st, _batch(cfg))
    imgs = tr.sample(st, N, gene=_batch(cfg)["rna_data"], seed=3)
    size = cfg.model.out_size
    assert imgs.shape == (N, size, size, 3) and imgs.permute(0, 3, 1, 2).is_contiguous()
    out, _ = st.generator.forward_stats(torch.zeros(N, cfg.model.encoding_dims), st.g_stats, False,
                                        labels=_labels(cfg))
    assert out.dtype == torch.float32 and out.is_contiguous() and not out.is_contiguous(memory_format=CL)


def test_the_cpu_keeps_nchw_and_counts_no_channels_last_convolution(counters):
    """Unpatched, the CPU's convolutions stay contiguous NCHW: counted, none channels-last."""
    cfg = _cfg("dcgan")
    tr = _trainer(cfg)
    tr.train_step_eager(tr.init_state(), _batch(cfg))
    assert counters["gan.convs"] > 0 and counters.get("gan.convs_channels_last", 0) == 0
    assert dcgan.conv_layout(torch.zeros(1)) == torch.contiguous_format


class _Convolutions(TorchDispatchMode):
    """Records the layouts of every convolution's (and convolution
    backward's) 4-D operands, and of every input batch of ``channels``
    channels (the discriminator's tiles) a convolution reads."""

    def __init__(self, channels=3):
        super().__init__()
        self.seen, self.images, self.channels = [], [], channels

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("convolution", "convolution_backward"):
            tensors = [a for a in args[:3] if isinstance(a, torch.Tensor) and a.ndim == 4]
            self.seen.append((name, tuple(_layout(t) for t in tensors)))
            if name == "convolution" and tensors[0].shape[:2] == (N, self.channels):
                self.images.append(_layout(tensors[0]))
        return func(*args, **(kwargs or {}))


def _layout(t):
    """"both" for a tensor that is contiguous in either order (a 1x1 map, a (C, 1, k, k) weight)."""
    cl, nchw = t.is_contiguous(memory_format=CL), t.is_contiguous()
    return "both" if cl and nchw else "channels_last" if cl else "nchw" if nchw else "other"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_convolution_of_the_step_reads_channels_last_operands(channels_last, arch):
    """Forward, backward and the penalty's double backward: every
    convolution and convolution backward reads channels-last operands; none
    reads the batch-transposed maps of autograd's own double backward. One
    exception: ``condgan``'s discriminator joins the labels' maps to its
    input, and the double backward of that join (a slice's backward) hands
    its first layer one contiguous gradient map. ``biggan_pub``'s pools
    (its critic's average pools, attention's max pools) keep the order; one
    exception there: in the penalty's double backward, the product of the
    critic attention's queries and keys (a ``bmm``) hands the query
    convolution one contiguous gradient map (its transposed convolution and
    its weight gradient; at 16 channels and up, where the queries have more
    than one)."""
    cfg = _cfg(arch)
    tr = _trainer(cfg)
    with _Convolutions(3 + (cfg.model.num_classes if arch == "condgan" else 0)) as log:
        tr.train_step_eager(tr.init_state(), _batch(cfg), _draws(cfg))
    assert {name for name, _ in log.seen} == {"convolution", "convolution_backward"}
    other = [(name, layouts) for name, layouts in log.seen if not set(layouts) <= {"channels_last", "both"}]
    expected = {"condgan": [("convolution_backward", ("nchw", "channels_last", "channels_last"))],
                "biggan_pub": [("convolution", ("nchw", "both")),
                               ("convolution_backward", ("nchw", "channels_last", "both"))]}
    assert other == expected.get(arch, [])
    assert log.images and set(log.images) == {"channels_last"}


SAGAN = dict(arch="sagan", encoding_dims=16, out_size=16, step_channels=4, attn_size=8, compute_dtype="float32")
BIGGAN = dict(arch="biggan", encoding_dims=24, out_size=16, step_channels=4, num_classes=2, attn_size=8,
              embed_dim=6, compute_dtype="float32")


@pytest.mark.parametrize("model", [SAGAN, BIGGAN], ids=["sagan", "biggan"])
def test_sagan_and_biggan_keep_their_nchw_path(monkeypatch, counters, model):
    """With the DCGAN nets on the card's layout, a SAGAN or BigGAN step runs
    the convolutions it runs without it, operand layouts and all (the image
    batch contiguous NCHW; SAGAN's attention makes its own strides), and
    counts none of them."""
    cfg = GANConfig(model=GANModelConfig(**model), vae=VAE_MODEL, batch_size=N, loss_type="wgan")
    logs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(dcgan, "conv_layout", lambda x: CL)
        tr = _trainer(cfg)
        with _Convolutions() as log:
            tr.train_step_eager(tr.init_state(), _batch(cfg), _draws(cfg))
        logs.append(log)
    assert logs[0].seen and logs[0].seen == logs[1].seen
    # the discriminator's tiles, real, fake and interpolated: contiguous NCHW
    assert logs[1].images and set(logs[1].images) == {"nchw"}
    assert "gan.convs" not in counters and "gan.convs_channels_last" not in counters


def test_the_weight_cast_is_one_copy_whose_gradient_is_contiguous():
    w = torch.randn(6, 5, 4, 4, dtype=torch.float64, requires_grad=True)
    out = dcgan.cast_weight(w, torch.float32, CL)
    assert out.dtype == torch.float32 and out.is_contiguous(memory_format=CL) and not out.is_contiguous()
    torch.testing.assert_close(out, w.detach().float(), rtol=0, atol=0)
    g = torch.randn(6, 5, 4, 4).to(memory_format=CL)
    (grad,) = torch.autograd.grad(out, w, g)
    assert grad.dtype == torch.float64 and grad.is_contiguous()
    torch.testing.assert_close(grad, g.double(), rtol=0, atol=0)
    # twice differentiable, as every op a penalty's double backward may cross
    cast = lambda t: dcgan.cast_weight(t, torch.float64, CL).sin()  # noqa: E731
    assert torch.autograd.gradgradcheck(cast, (w,))
    assert dcgan.cast_weight(w, torch.float32, torch.contiguous_format).is_contiguous()


def _discriminator_conv_against_conv2d(case, layout):
    """``discriminator_conv`` (``_Conv2d``, and the last block's dot product)
    on ``layout`` maps against ``F.conv2d``'s own autograd, at float64: the
    output, a penalty-style double backward's gradients for x, w and b, each
    map's gradient in the map's order."""
    gen = torch.Generator().manual_seed(4)
    shapes, stride, padding = ({"x": (2, 3, 8, 8), "w": (5, 3, 4, 4)}, (2, 2), (1, 1)) if case == "strided" else (
        {"x": (2, 6, 4, 4), "w": (1, 6, 4, 4)}, (1, 1), (0, 0))
    x0 = torch.randn(shapes["x"], generator=gen, dtype=torch.float64)
    w0 = torch.randn(shapes["w"], generator=gen, dtype=torch.float64)
    b0 = torch.randn(shapes["w"][0], generator=gen, dtype=torch.float64)

    def penalty(conv, layout):
        x = x0.to(memory_format=layout).requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        y = conv(x, dcgan.cast_weight(w, torch.float64, layout), b)
        (gx,) = torch.autograd.grad(torch.tanh(y).sum(), x, create_graph=True)
        assert gx.is_contiguous(memory_format=layout)
        return (y, *torch.autograd.grad((gx * gx).sum(), (x, w, b)))

    got = penalty(lambda x, w, b: dcgan.discriminator_conv(x, w, b, stride, padding), layout)
    want = penalty(lambda x, w, b: F.conv2d(x, w, b, stride, padding), torch.contiguous_format)
    for g, r in zip(got, want, strict=True):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["strided", "last"])
def test_the_discriminator_convolution_differentiates_twice_as_conv2d(case):
    _discriminator_conv_against_conv2d(case, CL)


@pytest.mark.parametrize("case", ["strided", "last"])
def test_the_discriminator_convolution_on_nchw_maps_differentiates_twice_as_conv2d(case):
    """The CPU's order: the same path, each gradient map contiguous NCHW."""
    _discriminator_conv_against_conv2d(case, torch.contiguous_format)


def test_the_noise_enters_as_an_nhwc_view():
    z = torch.randn(4, 6)
    cl = dcgan.noise_map(z, CL)
    assert cl.shape == (4, 6, 1, 1) and cl.stride() == (6, 1, 6, 6) and cl.data_ptr() == z.data_ptr()
    assert torch.equal(cl, z[:, :, None, None])
    assert dcgan.noise_map(z, torch.contiguous_format).stride() == (6, 1, 1, 1)


def test_the_reflect_pad_keeps_channels_last_and_its_values():
    x = torch.randn(2, 3, 6, 5, dtype=torch.float64).to(memory_format=CL).requires_grad_(True)
    y = dcgan._ReflectPad1.apply(x)
    want = F.pad(x, (1, 1, 1, 1), mode="reflect")
    assert y.is_contiguous(memory_format=CL)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    g = torch.randn_like(want)
    torch.testing.assert_close(torch.autograd.grad(y, x, g)[0], torch.autograd.grad(want, x, g)[0])
    c = x.detach().contiguous()
    torch.testing.assert_close(dcgan._ReflectPad1.apply(c), F.pad(c, (1, 1, 1, 1), mode="reflect"), rtol=0, atol=0)


@pytest.mark.parametrize("layout", [torch.contiguous_format, CL])
def test_the_penalty_sums_each_sample_over_its_map(layout):
    """The per-sample norm sums over (C, H, W) in place, whatever the layout;
    on a contiguous map exactly as a flattened sum."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 5, 5, generator=gen).to(memory_format=layout)
    w = torch.randn(4, 5, 5, generator=gen)
    critic = lambda v: (torch.tanh(v) * w).sum(dim=(1, 2, 3))  # noqa: E731
    gp = gan_losses.gradient_penalty(critic, x)
    xr = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(xr).sum(), xr)
    flat = torch.sqrt((grads * grads).contiguous().reshape(3, -1).sum(dim=1) + 1e-12)
    want = ((flat - 1.0) ** 2).mean()
    if layout == torch.contiguous_format:
        assert torch.equal(gp, want)
    else:
        torch.testing.assert_close(gp, want, rtol=1e-6, atol=0)


# -------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test captures and traces the full-width GAN step on the card")
    return torch.device("cuda", 0)


def _kernels_between(prof, tmp_path, first, last, durations=False):
    """The names of the kernels between two stage marks, in order; with
    ``durations``, (name, device µs) pairs."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"), key=lambda e: e["ts"])
    inside, out = False, []
    for e in kernels:
        name = e["name"]
        if profiling.MARK_PREFIX + first in name:
            inside = True
        elif profiling.MARK_PREFIX + last in name:
            inside = False
        elif inside:
            out.append((name, float(e["dur"])) if durations else name)
    return out


@pytest.mark.card
def test_the_captured_full_width_step_transposes_nothing(card, tmp_path):
    """``GANConfig()`` (256x256, bf16, batch 8, wganvae) captured: between its
    ``gan_ingest`` and ``end`` marks the profile holds no cuDNN layout
    transpose, every convolution counts as channels-last, and 3 captured
    steps give the losses of 3 eager steps from the same state bit for bit
    (cuDNN deterministic, as the card's captured-against-eager checks run)."""
    cfg = GANConfig()
    vae_sd = BetaVAE(cfg.vae, seed=3).state_dict()
    rs = np.random.RandomState(0)
    batches = [{"image": rs.randint(0, 256, (8, 256, 256, 3)).astype(np.uint8),
                "rna_data": rs.randn(8, cfg.vae.rna_features).astype(np.float32)} for _ in range(3)]
    tr = GANTrainer(cfg, vae_state_dict=vae_sd, device=card)
    st = tr.init_state()
    profiling.counters.pop("gan.convs", None)
    profiling.counters.pop("gan.convs_channels_last", None)
    tr.train_step(st, batches[0])  # captures
    assert profiling.counters["gan.convs_channels_last"] == profiling.counters["gan.convs"] > 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=card).add_(1)  # the session's first device record can go missing
        tr.train_step(st, batches[1])
        torch.cuda.synchronize()
    kernels = _kernels_between(prof, tmp_path, "gan_ingest", "end")
    assert any("fused_adam" in k for k in kernels)
    assert not [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]
    del tr, st
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = []
        for run in ("train_step", "train_step_eager"):
            tr = GANTrainer(cfg, vae_state_dict=vae_sd, device=card)
            st = tr.init_state()
            for batch in batches:
                _, met = getattr(tr, run)(st, batch)
            losses.append(torch.stack([met[k].float().reshape(()) for k in sorted(met)]).cpu())
            del tr, st
        assert torch.equal(losses[0], losses[1]), losses
    finally:
        torch.backends.cudnn.deterministic = prev


def _batch_norm_as_before(x, scale, bias, mean, var, *, train):
    """``batchnorm.batch_norm``'s one-device arithmetic written with
    ``Tensor.mean`` and ``xf - m``, autograd's own backwards throughout."""
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
    y = (xf - m.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype), new_mean, new_var


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["2d", "nchw", "channels_last"])
def test_batch_norm_keeps_the_bits_of_mean_and_subtract(case, dtype, train):
    """``batch_norm`` (``_Mean`` and ``xf + (-m)``) against its arithmetic
    with ``Tensor.mean`` and ``xf - m`` at rtol = atol = 0, on the β-VAE's
    2-D rows, ResNet's NCHW maps and the DCGAN nets' channels-last maps,
    over counts that are no power of 2: the output and running statistics,
    the first gradients of x, scale and bias, and a penalty-style gradient
    of x's gradient."""
    from rnagan_tpu_torch.models.batchnorm import batch_norm

    gen = torch.Generator().manual_seed(7)
    shape = (6, 5) if case == "2d" else (3, 5, 7, 6)
    x0 = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    if case == "channels_last":
        x0 = x0.to(memory_format=CL)
    scale0, bias0 = torch.randn(5, generator=gen), torch.randn(5, generator=gen)
    stats = (torch.randn(5, generator=gen), torch.rand(5, generator=gen) + 0.5)
    cot = torch.randn(shape, generator=gen).to(dtype)

    def run(bn):
        x = x0.clone().requires_grad_(True)
        scale, bias = scale0.clone().requires_grad_(True), bias0.clone().requires_grad_(True)
        y, new_mean, new_var = bn(x, scale, bias, *stats, train=train)
        gx, gs, gb = torch.autograd.grad((y.float() * cot.float()).sum(), (x, scale, bias), create_graph=True)
        twice = torch.autograd.grad((gx.float() * gx.float()).sum(), (x, scale, bias), allow_unused=True,
                                    materialize_grads=True)  # eval: x's gradient is linear; bias never enters it
        return y, new_mean, new_var, gx, gs, gb, *twice

    got, want = run(batch_norm), run(_batch_norm_as_before)
    for name, g, r in zip(("y", "mean", "var", "dx", "dscale", "dbias", "ddx", "ddscale", "ddbias"), got, want,
                          strict=True):
        torch.testing.assert_close(g, r, rtol=0, atol=0, msg=lambda m, name=name: f"{name}: {m}")
