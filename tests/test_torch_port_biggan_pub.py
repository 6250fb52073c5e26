"""The published BigGAN (arch ``biggan_pub``, ``models/biggan_pub.py``) against
the benchmark's plain float32 reference (``perfbench/reference/biggan.py`` and
``biggan_steps.py``, which import nothing of the port), on the CPU in float32.

Weights are the published initialization drawn from a seed, with every
bias, BatchNorm scale and bias and attention ``gamma`` then drawn at random
too, so each parameter enters the outputs. The 32x32 table has no attention
at ``attn_size`` 64; the 64x64 table at ``attn_size`` 32 runs it in both nets.

Tolerances, each the rounding of one float32 computation done in another
order (the port and the reference run the same equations; no tensor core,
no bf16): values and state 1e-5 relative and absolute; first gradients 2e-4
relative plus 1e-6 of the net's largest gradient element (the penalty's
double backward sums many products of both signs, and a convolution bias
in front of a BatchNorm has a gradient that vanishes in exact arithmetic,
so it holds rounding alone); losses and scores 1e-4; a parameter after one
Adam step 1e-6 absolute (the step is about the rate times the gradient's
sign, 1e-4 here, so 1e-6 is 1 %) where the reference gradient is above that
rounding floor, and there at most :data:`FLIPS` of the elements may differ,
by up to two steps (an element at rounding size flips its sign).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from perfbench.core.weights import load_into, vae_weights  # noqa: E402
from perfbench.reference import biggan as ref  # noqa: E402
from perfbench.reference import biggan_steps, draws  # noqa: E402
from rnagan_tpu_torch.core import profiling  # noqa: E402
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig  # noqa: E402
from rnagan_tpu_torch.losses import gan as gan_losses  # noqa: E402
from rnagan_tpu_torch.models import biggan as port_biggan  # noqa: E402
from rnagan_tpu_torch.models.biggan_pub import (PublishedBigGANDiscriminator, PublishedBigGANGenerator,  # noqa: E402
                                                spectral_norm)
from rnagan_tpu_torch.models.dcgan import make_discriminator, make_generator  # noqa: E402
from rnagan_tpu_torch.train.gan_trainer import GANTrainer  # noqa: E402

N = 4
#: the share of a net's parameter elements whose one-step change may differ (a gradient at rounding size)
FLIPS = 1e-3
#: a gradient's rounding floor, as a share of the net's largest gradient element
GRAD_FLOOR = 1e-6
SIZES = {"32": dict(out_size=32, attn_size=64), "64_attention": dict(out_size=64, attn_size=32)}
VAE = dict(rna_features=24, z_dim=40, encoder_dims=[20, 16], decoder_dims=[20], beta=5e-4, dropout_rate=0.5,
           leaky_slope=0.01, compute_dtype="float32")
HP = dict(noise_range=0.3, gp_lambda=10.0, g_lr=1e-4, d_lr=4e-4, b1=0.5, b2=0.999)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _m(size):
    return dict(arch="biggan_pub", out_channels=3, step_channels=4, encoding_dims=40, num_classes=2, embed_dim=8,
                compute_dtype="float32", **SIZES[size])


def _weights(m, seed=5):
    """The published initialization with every other parameter drawn at random."""
    w = ref.weights(m, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for net, name, shape, kind in ref.specs(m)[0]:
        if kind != "ortho":
            base = 1.0 if kind == "bn_scale" else 0.0
            w[net][name] = base + 0.3 * torch.randn(shape, generator=gen)
    return w


def _nets(m, w):
    cfg = GANModelConfig(**m)
    g, d = PublishedBigGANGenerator(cfg), PublishedBigGANDiscriminator(cfg)
    load_into(g, w["G"])
    load_into(d, w["D"])
    return g, d


def _state(w, net):
    return {k: v for k, v in w[net].items() if k.endswith(("running_mean", "running_var", "sn_u"))}


def _port_state(module, stats):
    """A net's state list by the reference's names (BatchNorm statistics and ``u``)."""
    names = {id(t): n for n, t in module.named_buffers()}
    out = {}
    for (a0, b0), (a, b) in zip(module.bn_stats(), stats, strict=True):
        out[names[id(a0)]] = a
        if names[id(a0)].endswith("running_mean"):
            out[names[id(b0)]] = b
    return out


def _close(got, want, rtol=1e-5, atol=1e-5):
    torch.testing.assert_close(got.detach().float(), want.detach().float(), rtol=rtol, atol=atol)


def _close_grads(got, want):
    """Gradients, 2e-4 relative plus 1e-6 of the net's largest gradient element (module docstring)."""
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want, strict=True):
        _close(a, b, 2e-4, floor)


def _inputs(m, seed=0):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((N, m["encoding_dims"]), generator=gen)
    labels = torch.tensor([0, 1, 1, 0])
    x = torch.rand((N, 3, m["out_size"], m["out_size"]), generator=gen) * 2 - 1
    return z, labels, x


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("train", [True, False])
def test_forwards_and_state_match_the_reference(size, train):
    m = _m(size)
    w = _weights(m)
    g, d = _nets(m, w)
    z, labels, x = _inputs(m)
    img, g_new = g.forward_stats(z, g.bn_stats(), train, labels=labels)
    img_ref, g_ref = ref.generator(w["G"], _state(w, "G"), z, labels, train, m)
    _close(img, img_ref)
    score, d_new = d(x, d.bn_stats(), train, labels=labels)
    score_ref, d_ref = ref.discriminator(w["D"], _state(w, "D"), x, labels, train, m)
    _close(score, score_ref)
    for module, new, want in ((g, g_new, g_ref), (d, d_new, d_ref)):
        got = _port_state(module, new)
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k])
    if not train:  # evaluation keeps the state
        assert all(a is s for (a, _), (s, _) in zip(g_new, g.bn_stats()))
    if size == "64_attention":
        assert any(k.startswith("blocks.2.1.") for k in dict(g.named_parameters()))
        assert any(k.startswith("blocks.0.1.") for k in dict(d.named_parameters()))


def test_spectral_norm_is_the_published_power_iteration():
    """``layers.SN``: u (1, out) against ``weight.view(out, -1)``, sigma the
    estimate with its gradient in the weight; sigma approaches the largest
    singular value as the iteration repeats."""
    gen = torch.Generator().manual_seed(3)
    weight = torch.randn((6, 3, 3, 3), generator=gen, requires_grad=True)
    u = torch.randn((1, 6), generator=gen)
    w, u1, sigma = spectral_norm(weight, u)
    mat = weight.detach().reshape(6, -1)
    v = torch.nn.functional.normalize(u @ mat)
    u_ref = torch.nn.functional.normalize(v @ mat.t())
    _close(u1, u_ref, 1e-6, 1e-7)
    _close(sigma, (v @ mat.t() @ u_ref.t())[0, 0], 1e-6, 1e-7)
    w.sum().backward()
    assert weight.grad is not None and not torch.allclose(weight.grad, torch.full_like(weight, 1 / float(sigma)))
    for _ in range(200):
        _, u1, sigma = spectral_norm(weight.detach(), u1)
    _close(sigma, torch.linalg.matrix_norm(mat, ord=2), 1e-4, 0.0)


@pytest.mark.parametrize("size", list(SIZES))
def test_first_gradients_with_the_penalty_match_the_reference(size):
    """D's critic loss plus the per-sample penalty (the double backward through
    both nets' spectral norms, BatchNorm-free critic and attention), and G's loss."""
    m = _m(size)
    w = _weights(m)
    g, d = _nets(m, w)
    z, labels, real = _inputs(m)
    eps = torch.rand((N, 1, 1, 1), generator=torch.Generator().manual_seed(9))
    dp = list(d.parameters())
    with torch.no_grad():
        fake, _ = g.forward_stats(z, g.bn_stats(), True, labels=labels)
    dx, s1 = d(real, d.bn_stats(), True, labels=labels)
    dgz, s2 = d(fake, s1, True, labels=labels)
    gp = gan_losses.gradient_penalty(lambda t: d(t, s2, True, labels=labels)[0], eps * real + (1 - eps) * fake)
    loss = (dgz - dx).mean() + 10.0 * gp
    grads = torch.autograd.grad(loss, dp)

    pd = {k: v.clone().requires_grad_(True) for k, v in w["D"].items() if k in dict(d.named_parameters())}
    state = _state(w, "D")
    with torch.no_grad():
        fake_ref, _ = ref.generator(w["G"], _state(w, "G"), z, labels, True, m)
    _close(fake, fake_ref)
    rx, r1 = ref.discriminator(pd, state, real, labels, True, m)
    rgz, r2 = ref.discriminator(pd, r1, fake_ref, labels, True, m)
    x_hat = (eps * real + (1 - eps) * fake_ref).requires_grad_(True)
    (gx,) = torch.autograd.grad(ref.discriminator(pd, r2, x_hat, labels, True, m)[0].sum(), x_hat, create_graph=True)
    rgp = ((torch.sqrt((gx * gx).reshape(N, -1).sum(1) + 1e-12) - 1.0) ** 2).mean()
    _close(gp, rgp, 1e-4, 1e-6)
    ref_grads = torch.autograd.grad((rgz - rx).mean() + 10.0 * rgp, [pd[k] for k, _ in d.named_parameters()])
    _close_grads(grads, ref_grads)

    gp_ = list(g.parameters())
    img, _ = g.forward_stats(z, g.bn_stats(), True, labels=labels)
    g_grads = torch.autograd.grad(-d(img, s2, True, labels=labels)[0].mean(), gp_)
    pg = {k: w["G"][k].clone().requires_grad_(True) for k, _ in g.named_parameters()}
    img_ref, _ = ref.generator(pg, _state(w, "G"), z, labels, True, m)
    g_loss = -ref.discriminator(w["D"], r2, img_ref, labels, True, m)[0].mean()
    _close_grads(g_grads, torch.autograd.grad(g_loss, list(pg.values())))


@pytest.mark.parametrize("size", list(SIZES))
def test_a_trainer_step_matches_the_reference_step(size):
    """One ``GANTrainer`` ``wganvae`` step with labels (eager on the CPU):
    losses, scores, the optimizer's first gradients, the parameters and
    the state after it, against ``biggan_steps.gan_steps``."""
    m = _m(size)
    w = _weights(m)
    vae_sd = vae_weights(VAE, 7, "cpu")
    cfg = GANConfig(model=GANModelConfig(**m), vae=VAEModelConfig(**{**VAE, "encoder_dims": (20, 16),
                                                                        "decoder_dims": (20,)}),
                    batch_size=N, seed=11)
    trainer = GANTrainer(cfg, vae_state_dict=vae_sd, device="cpu")
    state = trainer.init_state()
    load_into(state.generator, w["G"])
    load_into(state.discriminator, w["D"])
    state.g_stats = [(a.clone(), b.clone()) for a, b in state.generator.bn_stats()]
    state.d_stats = [(a.clone(), b.clone()) for a, b in state.discriminator.bn_stats()]
    gen = torch.Generator().manual_seed(4)
    batch = {"image": torch.rand((N, m["out_size"], m["out_size"], 3), generator=gen) * 2 - 1,
             "rna_data": torch.randn((N, VAE["rna_features"]), generator=gen), "labels": torch.tensor([1, 0, 0, 1])}
    _, metrics = trainer.train_step(state, batch)
    seeds = [[draws.stream_seed(cfg.seed, "train", 0, s) for s in range(4)]]
    out = biggan_steps.gan_steps(w["G"], w["D"], vae_sd, [batch], seeds, m, VAE, HP)
    for k in ("d_loss", "gp", "g_loss", "dx", "dgz"):
        _close(metrics[k], torch.tensor(out["losses"][0][k]), 1e-4, 1e-5)
    for net, module, opt in (("G", state.generator, state.g_opt), ("D", state.discriminator, state.d_opt)):
        names = [f"{net}.{name}" for name, _ in module.named_parameters()]
        want = [out["first_grads"][k] for k in names]
        _close_grads([mu / (1 - opt.b1) for mu in opt.mu], want)
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want)
        lr = HP["g_lr"] if net == "G" else HP["d_lr"]
        for name, p, g_ref in zip(names, module.parameters(), want, strict=True):
            diff = (p.detach() - out["state"][name]).abs()
            assert float(diff.max()) <= 2.01 * lr, name
            assert int((diff[g_ref.abs() > floor] > 1e-6).sum()) <= max(1, FLIPS * diff.numel()), name
    got = {**{f"G.{k}": v for k, v in _port_state(state.generator, state.g_stats).items()},
           **{f"D.{k}": v for k, v in _port_state(state.discriminator, state.d_stats).items()}}
    assert sorted(got) == sorted(ref.state_names(m))
    for k, v in got.items():
        _close(v, out["state"][k], 1e-4, 1e-5)


# -------------------------------------------------------------- wiring


def test_the_published_widths_and_counts():
    """The 256 table at ``step_channels`` 64: G's and D's parameters, the
    latent's 292-wide chunks with the last 4 columns left out, attention at
    64x64 in both nets; other sizes and unlabelled calls are refused."""
    cfg = GANModelConfig(arch="biggan_pub", out_size=256, step_channels=64, encoding_dims=2048, num_classes=2,
                         attn_size=64, embed_dim=128)
    g, d = PublishedBigGANGenerator(cfg, device="meta"), PublishedBigGANDiscriminator(cfg, device="meta")
    assert sum(p.numel() for p in g.parameters()) == 44_892_036
    assert sum(p.numel() for p in d.parameters()) == 43_423_938
    assert g.linear.weight.shape == (16 * 64 * 16, 292) and g.blocks[0][0].bn1.gain.weight.shape == (1024, 420)
    assert [len(b) for b in g.blocks] == [1, 1, 1, 2, 1, 1] and [len(b) for b in d.blocks] == [1, 2, 1, 1, 1, 1, 1]
    assert g.blocks[3][1].theta.weight.shape == (32, 256, 1, 1) and d.blocks[1][1].g.weight.shape == (64, 128, 1, 1)
    assert not hasattr(d.blocks[6][0], "conv_sc") and d.embed.sn_u.shape == (1, 2)
    with pytest.raises(ValueError, match="published tables"):
        PublishedBigGANGenerator(GANModelConfig(arch="biggan_pub", out_size=128, num_classes=2), device="meta")
    with pytest.raises(ValueError, match="num_classes"):
        PublishedBigGANDiscriminator(GANModelConfig(arch="biggan_pub", out_size=32, num_classes=0), device="meta")
    m = _m("32")
    g, d = _nets(m, _weights(m))
    with pytest.raises(ValueError, match="requires labels"):
        g.forward_stats(torch.randn(2, 40), g.bn_stats(), True)


def test_the_registry_keeps_the_port_s_biggan():
    """``biggan`` is still the JAX package's net (its parity tests hold it
    there); ``biggan_pub`` is a net of its own, registered beside it."""
    small = dict(out_size=32, step_channels=4, encoding_dims=40, num_classes=2, attn_size=64, compute_dtype="float32")
    old = GANModelConfig(arch="biggan", **small)
    assert type(make_generator(old)) is port_biggan.BigGANGenerator
    assert type(make_discriminator(old)) is port_biggan.BigGANDiscriminator
    new = GANModelConfig(arch="biggan_pub", **small)
    assert type(make_generator(new)) is PublishedBigGANGenerator
    assert type(make_discriminator(new)) is PublishedBigGANDiscriminator


def test_the_port_s_import_check_covers_the_module():
    """``test_torch_port_hygiene.py`` imports every module of the port with
    JAX, pandas and the JAX package blocked; ``models/biggan_pub.py`` is among them."""
    from test_torch_port_hygiene import _IMPORT_ALL_BLOCKED

    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL_BLOCKED], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "rnagan_tpu_torch.models.biggan_pub" in res.stdout.split()


# ------------------------------------------------------------- counters


def _counted(monkeypatch, fn):
    monkeypatch.setattr(profiling, "counters", {})
    fn()
    return dict(profiling.counters)


def test_the_counters_count_as_stated(monkeypatch):
    """A training forward counts each weight-bearing layer in ``gan.layers``
    and each spectrally normalized one in ``gan.sn_layers`` (all of
    ``biggan_pub``'s; the port's ``biggan`` leaves its conditional BatchNorm
    projections unnormalized); every attention call counts in
    ``gan.attn_calls``, an evaluation forward's too; DCGAN counts none of them."""
    m = _m("64_attention")
    g, d = _nets(m, _weights(m))
    z, labels, x = _inputs(m)
    sn_g = sum(1 for mod in g.modules() if hasattr(mod, "sn_u"))
    c = _counted(monkeypatch, lambda: g.forward_stats(z, g.bn_stats(), True, labels=labels))
    assert c == {"gan.layers": sn_g, "gan.sn_layers": sn_g, "gan.attn_calls": 1}
    sn_d = sum(1 for mod in d.modules() if hasattr(mod, "sn_u"))
    c = _counted(monkeypatch, lambda: d(x, d.bn_stats(), True, labels=labels))
    assert c == {"gan.layers": sn_d, "gan.sn_layers": sn_d, "gan.attn_calls": 1}
    c = _counted(monkeypatch, lambda: g.forward_stats(z, g.bn_stats(), False, labels=labels))
    assert c == {"gan.attn_calls": 1}
    old = make_generator(GANModelConfig(arch="biggan", out_size=16, step_channels=4, encoding_dims=24, num_classes=2,
                                        attn_size=8, embed_dim=6, compute_dtype="float32"))
    c = _counted(monkeypatch, lambda: old.forward_stats(torch.randn(2, 24), old.bn_stats(), True,
                                                        labels=torch.tensor([0, 1])))
    cbn = sum(1 for mod in old.modules() if isinstance(mod, port_biggan.ConditionalBatchNorm))
    assert c["gan.layers"] == c["gan.sn_layers"] + 2 * cbn and c["gan.attn_calls"] == 1
    dc = make_generator(GANModelConfig(out_size=16, step_channels=4, encoding_dims=8, compute_dtype="float32"))
    c = _counted(monkeypatch, lambda: dc.forward_stats(torch.randn(2, 8), dc.bn_stats(), True))
    assert not {"gan.layers", "gan.sn_layers", "gan.attn_calls"} & set(c)


def test_the_step_trains_through_the_trainer_s_checks():
    """``GANTrainer`` takes the arch as conditional and spectrally normalized:
    unlabelled batches and the fused critic batch are refused; the sample
    grid draws labels."""
    m = _m("32")
    cfg = GANConfig(model=GANModelConfig(**m), loss_type="wgan", clip=None, batch_size=2)
    trainer = GANTrainer(cfg, device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError, match="labels"):
        trainer.train_step(state, {"image": np.zeros((2, 32, 32, 3), np.float32)})
    _, metrics = trainer.train_step(state, {"image": np.zeros((2, 32, 32, 3), np.float32), "labels": [0, 1]})
    assert all(torch.isfinite(v) for v in metrics.values())
    assert trainer.sample(state, 3).shape == (3, 32, 32, 3)
    with pytest.raises(ValueError, match="fused_critic_batch"):
        GANTrainer(GANConfig(model=GANModelConfig(**m), fused_critic_batch=True, loss_type="wgan"), device="cpu")


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two tissue CSVs of 3 slides each, a store of 32x32 tiles a slide, a
    ``.pt`` β-VAE and a GAN config at tiny widths (attention at 16x16)."""
    from rnagan_tpu_torch.data import patches, store
    from rnagan_tpu_torch.models.betavae import BetaVAE

    root = tmp_path_factory.mktemp("biggan_pub_cli")
    rng = np.random.RandomState(0)
    genes, csvs, tiles = 12, [], root / "tiles"
    for t in range(2):
        names = [f"GTEX-{t}{i}.svs" for i in range(3)]
        rows = [",".join([f"rna_G{j}" for j in range(genes)] + ["wsi_file_name"])]
        rows += [",".join([str(float(v)) for v in rng.randint(0, 300, genes)] + [n]) for n in names]
        (root / f"tissue{t}.csv").write_text("\n".join(rows) + "\n")
        csvs.append(str(root / f"tissue{t}.csv"))
        for name in names:
            db = patches.slide_db_path(str(tiles), name)
            Path(db).parent.mkdir(parents=True)
            with store.LMDBTileWriter(db) as w:
                for i in range(4):
                    w.put_tile(f"{name}_{i}", rng.randint(0, 256, (32, 32, 3), dtype=np.uint8))
    vae = VAEModelConfig(rna_features=genes, z_dim=40, encoder_dims=(10, 8), decoder_dims=(10,))
    torch.save(BetaVAE(vae, seed=2).state_dict(), root / "vae.pt")
    config = {"path_csv": csvs, "patch_data_path": [str(tiles)] * 2, "img_size": 32, "encoding_dims": 40,
              "step_channels": 4, "attn_size": 16, "embed_dim": 8, "compute_dtype": "float32",
              "rna_features": genes, "z_dim": 40, "encoder_dims": [10, 8], "decoder_dims": [10]}
    (root / "gan.json").write_text(__import__("json").dumps(config))
    return root


def test_gan_train_cli_trains_biggan_pub_and_generate_refuses_it(workspace):
    from rnagan_tpu_torch.cli import gan_train, generate

    models = workspace / "models"
    res = gan_train.main(["--config", str(workspace / "gan.json"), "--gan_type", "biggan_pub", "--device", "cpu",
                          "--num_epochs", "1", "--num_patches", "4", "--batch_size", "4",
                          "--vae_checkpoint", str(workspace / "vae.pt"), "--model_dir", str(models),
                          "--image_dir", str(workspace / "images")])
    last = res["history"][-1]
    assert res["data"] == {**res["data"], "slides": 6, "tiles": 24}
    assert all(np.isfinite(last[k]) for k in ("d_loss", "gp", "g_loss"))
    assert (workspace / "images" / "epoch_0.png").exists()
    bundle = torch.load(models / "gan_last.model", weights_only=False)
    assert bundle["step"] == 6 and "blocks.1.1.gamma" in bundle["generator"]  # attention at 16x16
    assert bundle["discriminator"]["embed.weight"].shape == (2, 16)  # one class per CSV
    with pytest.raises(SystemExit, match="biggan_pub"):
        generate.main(["--config", str(workspace / "gan.json"), "--checkpoint", str(models / "gan_last.model"),
                       "--gan_type", "biggan_pub", "--device", "cpu"])


# ----------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test captures steps on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_a_captured_step_is_the_eager_step_and_marks_its_attention(card, tmp_path):
    """A captured ``wganvae`` step against the same step eager, from copies of
    one state (float32, TF32 off, attention in both nets), held as the CPU
    test holds the port to the reference: the eager step is not bit-stable on
    the card (two eager runs from one state differ by the order of atomic
    sums), so the losses, gradients, parameters and state are compared within
    the module's tolerances. A replay holds each stage's mark in order,
    ``gan_attn`` nested where the attention runs. On a machine with a card:
    ``python -m pytest tests/test_torch_port_biggan_pub.py -q -m card --noconftest``."""
    import copy
    import json

    from torch.profiler import ProfilerActivity, profile

    from test_torch_port_tracing import GAN_MARKS, _with_attention

    m = _m("64_attention")
    w = {net: {k: v.to(card) for k, v in sd.items()} for net, sd in _weights(m).items()}
    cfg = GANConfig(model=GANModelConfig(**m), vae=VAEModelConfig(**{**VAE, "encoder_dims": (20, 16),
                                                                        "decoder_dims": (20,)}),
                    batch_size=N, seed=11)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        trainer = GANTrainer(cfg, vae_state_dict=vae_weights(VAE, 7, card), device=card)
        assert trainer.captures()
        s0 = trainer.init_state()
        load_into(s0.generator, w["G"])
        load_into(s0.discriminator, w["D"])
        s0.g_stats = [(a.clone(), b.clone()) for a, b in s0.generator.bn_stats()]
        s0.d_stats = [(a.clone(), b.clone()) for a, b in s0.discriminator.bn_stats()]
        gen = torch.Generator(device=card).manual_seed(4)
        batch = {"image": torch.rand((N, 64, 64, 3), generator=gen, device=card) * 2 - 1,
                 "rna_data": torch.randn((N, VAE["rna_features"]), generator=gen, device=card),
                 "labels": torch.randint(0, 2, (N,), generator=gen, device=card)}
        trainer.train_step_eager(copy.deepcopy(s0), batch)  # cuDNN's first calls
        cap, eag = copy.deepcopy(s0), copy.deepcopy(s0)
        m_cap, m_eag = trainer.train_step(cap, batch)[1], trainer.train_step_eager(eag, batch)[1]
        for k in m_eag:
            _close(m_cap[k], m_eag[k], 1e-4, 1e-5)
        for c_net, e_net, c_opt, e_opt, lr in ((cap.generator, eag.generator, cap.g_opt, eag.g_opt, cfg.g_lr),
                                               (cap.discriminator, eag.discriminator, cap.d_opt, eag.d_opt,
                                                cfg.d_lr)):
            want = [mu / (1 - e_opt.b1) for mu in e_opt.mu]
            _close_grads([mu / (1 - c_opt.b1) for mu in c_opt.mu], want)
            floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want)
            for (name, p), q, g in zip(c_net.named_parameters(), e_net.parameters(), want, strict=True):
                diff = (p - q).detach().abs()
                assert float(diff.max()) <= 2.01 * lr, name
                assert int((diff[g.abs() > floor] > 1e-6).sum()) <= max(1, FLIPS * diff.numel()), name
        for a, b in zip(cap.g_stats + cap.d_stats, eag.g_stats + eag.d_stats, strict=True):
            for x, y in zip(a, b):
                _close(x, y, 1e-4, 1e-5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=card).add_(1)  # the session's first device record can go missing: not a mark
            trainer.train_step(cap, batch)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"), key=lambda e: e["ts"])
    marks = [e["name"].split(profiling.MARK_PREFIX)[1].split("(")[0] for e in kernels
             if profiling.MARK_PREFIX in e["name"]]
    assert marks == _with_attention(GAN_MARKS, {"gan_g_forward": 1, "gan_d_forward": 2, "gan_gp": 1,
                                                "gan_g_step": 2})
