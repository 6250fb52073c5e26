"""The port's training slice against the JAX package on the CPU, at float32.

Both packages get the same weights (numpy trees in the flax layout, carried
across by ``rnagan_tpu_torch.convert``), the same batches and the same random
draws: the JAX step reads its noise from the batch's ``"rng"`` key, and the
test regenerates those draws (``fold_in(key, i)``, the stage order of
``gan_trainer.py:227``) and hands them to the port as ``draws``. Weights are
scaled so activations are O(1), and every step starts from a step-5 state
whose Adam ``nu`` is far above ``(1-b2)*g^2``, so the update is a smooth
function of the gradient and not the sign(g)*lr of a first step.

Tolerances: forward values and BatchNorm statistics 1e-5; one train step's
parameters rtol 1e-6 / atol 1e-7 (a step moves them by ~lr); its metrics rtol
1e-4 and its Adam moments rtol 1e-4 plus 1e-5 of each tensor's largest value
(XLA and PyTorch sum the gradients of the double backward in other orders,
and small elements come from cancelling sums); Adam counts exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_parity import _bn, jax_generator_variables, jax_vae_variables

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.losses import gan as jlosses
from rnagan_tpu.models.dcgan import _BN, make_discriminator, make_generator
from rnagan_tpu.models.dcgan_torch import export_torchgan_bundle, import_torchgan_bundle
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu.train.gan_trainer import GANTrainState as JaxState
from rnagan_tpu.utils import images as jimages
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.losses import gan as tlosses
from rnagan_tpu_torch.models.batchnorm import batch_norm
from rnagan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator, num_repeats
from rnagan_tpu_torch.train.gan_trainer import GANTrainer
from rnagan_tpu_torch.utils import images as timages

MODEL_KW = dict(out_size=32, encoding_dims=32, step_channels=8, compute_dtype="float32")
VAE_KW = dict(rna_features=20, z_dim=32, encoder_dims=(24, 32), decoder_dims=(24,),
              compute_dtype="float32")
N = 4  # batch
F32 = np.float32


def _np(t):
    return t.detach().float().cpu().numpy()


def jax_discriminator_variables(cfg, seed=0):
    """Random ``DCGANDiscriminator`` params/batch_stats in the flax layout,
    scaled so every layer's output is O(1)."""
    rng = np.random.RandomState(seed)
    r = num_repeats(cfg.out_size)
    chans = [cfg.out_channels] + [cfg.step_channels * 2**b for b in range(r + 1)] + [1]
    params, stats = {}, {}
    for b in range(r + 2):
        cin, cout = chans[b], chans[b + 1]
        leaf = {"kernel": (rng.randn(4, 4, cin, cout) / np.sqrt(16 * cin)).astype(F32)}
        has_bn = cfg.batchnorm and 1 <= b <= r
        if not has_bn:
            leaf["bias"] = (0.1 * rng.randn(cout)).astype(F32)
        params[f"Conv_{b}"] = leaf
        if has_bn:
            bp, bs = _bn(rng, cout)
            params[f"_BN_{b - 1}"] = {"BatchNorm_0": bp}
            stats[f"_BN_{b - 1}"] = {"BatchNorm_0": bs}
    if cfg.critic == "projection":
        d = chans[r + 1]
        params["cond_proj"] = {"kernel": (rng.randn(cfg.encoding_dims, d)
                                          / np.sqrt(cfg.encoding_dims * d)).astype(F32)}
    return params, stats


def _stats(tree, n):
    return [(tree[f"_BN_{i}"]["BatchNorm_0"]["mean"], tree[f"_BN_{i}"]["BatchNorm_0"]["var"])
            for i in range(n)]


def _close_stats(got, ref, rtol=1e-5, atol=1e-6):
    assert len(got) == len(ref)
    for (gm, gv), (rm, rv) in zip(got, ref):
        np.testing.assert_allclose(_np(gm), np.asarray(rm), rtol=rtol, atol=atol)
        np.testing.assert_allclose(_np(gv), np.asarray(rv), rtol=rtol, atol=atol)


def _close_list(got, ref, rtol, atol, scaled=0.0):
    """Tensor by tensor; ``scaled`` adds that share of the tensor's largest
    magnitude to ``atol`` (a gradient's small elements come from cancelling sums)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = _np(r)
        np.testing.assert_allclose(_np(g), r, rtol=rtol, atol=atol + scaled * float(np.abs(r).max()))


def _models(**model_kw):
    kw = {**MODEL_KW, **model_kw}
    return jcfg.GANModelConfig(**kw), tcfg.GANModelConfig(**kw)


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(rng, train, dtype):
    """``models/batchnorm.py`` against the JAX package's ``_BN`` (flax
    BatchNorm, momentum 0.9, fast variance): output and updated statistics.
    bfloat16 outputs agree to one bf16 rounding (2**-8 relative)."""
    x = (rng.randn(6, 5, 3, 3) * 2 + 1).astype(F32)
    params, stats = _bn(rng, 5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    ref, upd = _BN(jdt).apply({"params": {"BatchNorm_0": params}, "batch_stats": {"BatchNorm_0": stats}},
                              xj, train, mutable=["batch_stats"])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(0, 3, 1, 2)
    y, m, v = batch_norm(xt.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32),
                         *(torch.from_numpy(a) for a in (params["scale"], params["bias"],
                                                         stats["mean"], stats["var"])), train=train)
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tol = 1e-5 if dtype == "float32" else 2**-8
    np.testing.assert_allclose(_np(y.permute(0, 2, 3, 1)), np.asarray(ref, F32), rtol=tol, atol=tol)
    _close_stats([(m, v)], [(upd["batch_stats"]["BatchNorm_0"]["mean"],
                             upd["batch_stats"]["BatchNorm_0"]["var"])])


def test_generator_train_mode_updates_stats_like_flax(rng):
    """One train-mode forward of the generator: output and running statistics
    against flax's updated ``batch_stats`` (biased variance, momentum 0.9),
    through the module's own ``forward`` (the BN buffers)."""
    jm, tm = _models()
    g_params, g_stats = jax_generator_variables(jm, seed=3)
    z = rng.randn(6, MODEL_KW["encoding_dims"]).astype(F32)
    ref, upd = make_generator(jm).apply({"params": g_params, "batch_stats": g_stats}, jnp.asarray(z),
                                        train=True, mutable=["batch_stats"])
    port = DCGANGenerator(tm)
    port.load_state_dict(convert.generator_state_dict_from_jax(tm, g_params, g_stats))
    out = port.train()(torch.from_numpy(z))
    np.testing.assert_allclose(_np(out.permute(0, 2, 3, 1)), np.asarray(ref), atol=1e-5)
    sd = port.state_dict()
    r = num_repeats(MODEL_KW["out_size"])
    _close_stats([(sd[f"model.{b}.1.running_mean"], sd[f"model.{b}.1.running_var"])
                  for b in range(r + 1)], _stats(upd["batch_stats"], r + 1))


def test_generator_bfloat16_train_mode_runs(rng):
    """The bfloat16 train-mode forward (the default compute type) no longer
    refuses: float32 output and statistics, near the float32 forward's."""
    _, tm = _models()
    z = torch.from_numpy(rng.randn(6, MODEL_KW["encoding_dims"]).astype(F32))
    outs = []
    for dt in ("float32", "bfloat16"):
        g = DCGANGenerator(tcfg.GANModelConfig(**{**MODEL_KW, "compute_dtype": dt}), seed=1)
        out, stats = g.forward_stats(z, g.bn_stats(), True)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        outs.append(stats)
    for (m32, v32), (m16, v16) in zip(*outs):
        np.testing.assert_allclose(_np(m16), _np(m32), atol=2e-3)
        np.testing.assert_allclose(_np(v16), _np(v32), rtol=2e-2, atol=1e-3)


# ---------------------------------------------------------- discriminator


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("batchnorm,critic", [(True, "unconditional"), (False, "unconditional"),
                                              (True, "projection")])
def test_discriminator_matches_jax(rng, batchnorm, critic, train):
    jm, tm = _models(batchnorm=batchnorm, critic=critic)
    params, stats = jax_discriminator_variables(jm, seed=5)
    jd = make_discriminator(jm)
    x = rng.randn(N, 32, 32, 3).astype(F32)
    cond = rng.randn(N, MODEL_KW["encoding_dims"]).astype(F32)
    kw = {"cond": jnp.asarray(cond)} if critic == "projection" else {}
    shapes = jax.eval_shape(lambda k: jd.init(k, jnp.asarray(x), train=False, **kw), jax.random.key(0))
    assert jax.tree_util.tree_structure(shapes["params"]) == jax.tree_util.tree_structure(params)
    ref, upd = jd.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                        mutable=["batch_stats"], **kw)
    port = DCGANDiscriminator(tm)
    port.load_state_dict(convert.discriminator_state_dict_from_jax(tm, params, stats))
    got, new = port(torch.from_numpy(x).permute(0, 3, 1, 2), port.bn_stats(), train,
                    torch.from_numpy(cond) if critic == "projection" else None)
    assert got.shape == (N,)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    r = num_repeats(MODEL_KW["out_size"]) if batchnorm else 0
    _close_stats(new, _stats(upd.get("batch_stats", {}), r))


def test_discriminator_later_archs_and_projection_cond():
    for arch in ("dcgan_up", "condgan"):  # trained too (tests/test_torch_port_train_archs.py)
        model = tcfg.GANModelConfig(**{**MODEL_KW, "arch": arch, "num_classes": 2})
        st = GANTrainer(tcfg.GANConfig(model=model, loss_type="wgan"), device="cpu").init_state()
        assert st.discriminator.cfg.arch == st.generator.cfg.arch == arch
    for arch in ("sagan", "biggan"):  # their own classes (tests/test_torch_port_attention_gans.py)
        with pytest.raises(ValueError, match=arch):
            DCGANDiscriminator(tcfg.GANModelConfig(**{**MODEL_KW, "arch": arch}))
    d = DCGANDiscriminator(tcfg.GANModelConfig(**{**MODEL_KW, "critic": "projection"}))
    with pytest.raises(ValueError, match="requires cond"):
        d(torch.zeros(2, 3, 32, 32), d.bn_stats(), False)


# ----------------------------------------------------------------- losses


def test_losses_match_jax(rng):
    dx, dgz = rng.randn(8).astype(F32), rng.randn(8).astype(F32)
    tx, tg = torch.from_numpy(dx), torch.from_numpy(dgz)
    pairs = [
        (jlosses.wasserstein_generator_loss(dgz), tlosses.wasserstein_generator_loss(tg)),
        (jlosses.wasserstein_discriminator_loss(dx, dgz), tlosses.wasserstein_discriminator_loss(tx, tg)),
        (jlosses.minimax_generator_loss(dgz), tlosses.minimax_generator_loss(tg)),
        (jlosses.minimax_generator_loss(dgz, False), tlosses.minimax_generator_loss(tg, False)),
        (jlosses.minimax_discriminator_loss(dx, dgz), tlosses.minimax_discriminator_loss(tx, tg)),
        (jlosses.least_squares_generator_loss(dgz), tlosses.least_squares_generator_loss(tg)),
        (jlosses.least_squares_discriminator_loss(dx, dgz),
         tlosses.least_squares_discriminator_loss(tx, tg)),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=1e-7)
    params = {"a": rng.randn(5).astype(F32)}
    ref = jlosses.clip_params(params, -0.1, 0.1)
    t = torch.from_numpy(params["a"].copy())
    tlosses.clip_params([t], -0.1, 0.1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref["a"]))


@pytest.mark.parametrize("per_sample", [True, False])
def test_gradient_penalty_and_its_double_backward_match_jax(rng, per_sample):
    """The penalty on a train-mode critic with BatchNorm, and its gradient
    with respect to the critic's parameters (the double backward)."""
    jm, tm = _models()
    params, stats = jax_discriminator_variables(jm, seed=7)
    jd = make_discriminator(jm)
    x = rng.randn(N, 32, 32, 3).astype(F32)

    def jgp(p):
        critic = lambda v: jd.apply({"params": p, "batch_stats": stats}, v, train=True,  # noqa: E731
                                    mutable=["batch_stats"])[0]
        return jlosses.gradient_penalty(critic, jnp.asarray(x), per_sample=per_sample)

    ref, ref_grads = jax.value_and_grad(jgp)(params)
    port = DCGANDiscriminator(tm)
    port.load_state_dict(convert.discriminator_state_dict_from_jax(tm, params, stats))
    gp = tlosses.gradient_penalty(lambda v: port(v, port.bn_stats(), True)[0],
                                  torch.from_numpy(x).permute(0, 3, 1, 2), per_sample=per_sample)
    # (norm - 1)^2 cancels: 1e-4 relative, as the gradients
    np.testing.assert_allclose(_np(gp), np.asarray(ref), rtol=1e-4)
    grads = torch.autograd.grad(gp, list(port.parameters()))
    _close_list(grads, convert.param_list_from_jax(tm, "discriminator", ref_grads), rtol=1e-4, atol=1e-7, scaled=1e-5)


# ------------------------------------------------------------- train step

#: name -> (GANConfig fields, GANModelConfig fields, steps, uint8 batch)
CASES = {
    "wganvae": ({}, {}, 1, False),
    "compat_reference_gp": ({"compat_reference_gp": True}, {}, 1, False),
    "wgan_clip": ({"loss_type": "wgan"}, {}, 1, False),
    "lsgan": ({"loss_type": "lsgan"}, {}, 1, False),
    "n_critic_2": ({"n_critic": 2}, {}, 2, False),
    "g_ema": ({"g_ema_decay": 0.5}, {}, 1, False),
    "projection": ({}, {"critic": "projection"}, 1, False),
    "uint8_batch": ({}, {}, 1, True),
    "mu_bfloat16": ({"adam_mu_dtype": "bfloat16"}, {}, 1, False),
}


def _cfgs(cfg_kw, model_kw):
    jm, tm = _models(**model_kw)
    jc = jcfg.GANConfig(model=jm, vae=jcfg.VAEModelConfig(**VAE_KW), batch_size=N, **cfg_kw)
    tc = tcfg.GANConfig(model=tm, vae=tcfg.VAEModelConfig(**VAE_KW), batch_size=N, **cfg_kw)
    return jc, tc


def _jax_state(jtr, jc, seed=0):
    """A JAX ``GANTrainState`` at step 5: random weights, G's Adam count 5 and
    D's 7, random moments (nu far above (1-b2)*g^2), EMA near the weights."""
    rng = np.random.RandomState(seed)
    g_params, g_stats = jax_generator_variables(jc.model, seed=seed + 1)
    d_params, d_stats = jax_discriminator_variables(jc.model, seed=seed + 2)
    mu_dt = jnp.bfloat16 if jc.adam_mu_dtype == "bfloat16" else jnp.float32

    def opt(tx, params, count):
        st = tx.init(params)
        mu = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape) * 1e-3, mu_dt), params)
        nu = jax.tree_util.tree_map(lambda p: (rng.rand(*p.shape) + 0.5).astype(F32) * 1e-2, params)
        return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])

    g_ema = None
    if jc.g_ema_decay is not None:
        g_ema = jax.tree_util.tree_map(lambda p: p + (0.01 * rng.randn(*p.shape)).astype(F32), g_params)
    return JaxState(step=jnp.asarray(5, jnp.int32), g_params=g_params, g_stats=g_stats,
                    g_opt=opt(jtr.g_tx, g_params, 5), d_params=d_params, d_stats=d_stats,
                    d_opt=opt(jtr.d_tx, d_params, 7), g_ema=g_ema)


def _port_state(tr, tc, js):
    """The port's state holding exactly the JAX state ``js``."""
    m = tc.model
    st = tr.init_state()
    st.generator.load_state_dict(convert.generator_state_dict_from_jax(m, js.g_params, js.g_stats))
    st.discriminator.load_state_dict(convert.discriminator_state_dict_from_jax(m, js.d_params, js.d_stats))
    st.g_stats = [(a.clone(), b.clone()) for a, b in st.generator.bn_stats()]
    st.d_stats = [(a.clone(), b.clone()) for a, b in st.discriminator.bn_stats()]
    for opt, jopt, net in ((st.g_opt, js.g_opt, "generator"), (st.d_opt, js.d_opt, "discriminator")):
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        opt.mu = [t.to(opt.mu_dtype) for t in mus]
        opt.nu = nus
        opt.count = int(jopt[0].count)
    if js.g_ema is not None:
        st.g_ema = convert.param_list_from_jax(m, "generator", js.g_ema)
    st.step = int(js.step)
    return st


def _draws(key, jc):
    """The stage draws of ``_train_step_impl`` for the batch key ``key``."""
    k_d, k_gp, k_g, k_eps = (jax.random.fold_in(key, i) for i in range(4))
    shape = (N, jc.model.encoding_dims)
    if jc.loss_type == "wganvae":
        draw = lambda k: jax.random.uniform(k, shape, jnp.float32, -jc.noise_range, jc.noise_range)  # noqa: E731
    else:
        draw = lambda k: jax.random.normal(k, shape, jnp.float32)  # noqa: E731
    eps_shape = () if jc.compat_reference_gp else (N, 1, 1, 1)
    return {"u_d": np.asarray(draw(k_d)), "u_gp": np.asarray(draw(k_gp)),
            "u_g": np.asarray(draw(k_g)), "eps": np.asarray(jax.random.uniform(k_eps, eps_shape))}


@pytest.fixture(scope="module")
def vae():
    vars_ = jax_vae_variables(jcfg.VAEModelConfig(**VAE_KW), seed=11)
    return vars_, convert.betavae_state_dict_from_jax(tcfg.VAEModelConfig(**VAE_KW), vars_)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(vae, case):
    cfg_kw, model_kw, steps, uint8 = CASES[case]
    jc, tc = _cfgs(cfg_kw, model_kw)
    vae_vars, vae_sd = vae
    wganvae = jc.loss_type == "wganvae"
    jtr = JaxGANTrainer(jc, vae_variables=vae_vars if wganvae else None,
                        mesh=make_mesh(devices=jax.devices()[:1]))
    js = _jax_state(jtr, jc)
    tr = GANTrainer(tc, vae_sd if wganvae else None, device="cpu")
    ts = _port_state(tr, tc, js)
    rng = np.random.RandomState(1)
    for k in range(steps):
        img = (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8)
        image = img if uint8 else (img.astype(F32) / 127.5 - 1.0)
        batch = {"image": image, "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
        key = jax.random.key(100 + k)
        js, jmet = jtr._train_step(js, {**batch, "rng": key}, jtr.vae_variables)
        ts, tmet = tr.train_step(ts, batch, draws=_draws(key, jc))
        assert set(tmet) == set(jmet)
        for name in jmet:
            np.testing.assert_allclose(_np(tmet[name]), np.asarray(jmet[name]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {k} {name}")
    m = tc.model
    r = num_repeats(m.out_size)
    assert ts.step == int(js.step) == 5 + steps
    for mod, jparams, jstats, opt, jopt, net, n_bn in (
            (ts.generator, js.g_params, js.g_stats, ts.g_opt, js.g_opt, "generator", r + 1),
            (ts.discriminator, js.d_params, js.d_stats, ts.d_opt, js.d_opt, "discriminator", r)):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=1e-6, atol=1e-7)
        _close_stats(ts.g_stats if net == "generator" else ts.d_stats, _stats(jstats, n_bn))
        assert opt.count == int(jopt[0].count)
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        mu_tol = 1e-4 if opt.mu_dtype == torch.float32 else 2**-7  # a bf16 mu: one rounding
        _close_list(opt.mu, mus, rtol=mu_tol, atol=1e-7, scaled=1e-5)
        _close_list(opt.nu, nus, rtol=1e-4, atol=1e-9, scaled=1e-5)
    if js.g_ema is not None:
        _close_list(ts.g_ema, convert.param_list_from_jax(m, "generator", js.g_ema), rtol=1e-6, atol=1e-7)


def test_train_step_draws_its_own_noise_deterministically(vae):
    """Without ``draws`` the stage noise comes from K1's Philox seeds and the
    eps generator of ``core/rng.py``: the same state and batch give the same
    step, another run seed another one."""
    _, tc = _cfgs({}, {})
    rng = np.random.RandomState(2)
    batch = {"image": (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8),
             "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
    losses = []
    for seed in (99, 99, 7):
        tr = GANTrainer(tcfg.GANConfig(**{**tc.__dict__, "seed": seed}), vae[1], device="cpu")
        st = tr.init_state()
        g = GANTrainer(tc, vae[1], device="cpu").init_state().generator.state_dict()
        st.generator.load_state_dict(g)  # the same init for every run seed
        st.discriminator.load_state_dict(GANTrainer(tc, vae[1], device="cpu").init_state()
                                         .discriminator.state_dict())
        _, met = tr.train_step(st, batch)
        losses.append(float(met["d_loss"]))
    assert losses[0] == losses[1] != losses[2]


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def trained(vae, tmp_path_factory):
    """A port trainer (wganvae, small) after two steps, and its JAX twin."""
    jc, tc = _cfgs({}, {})
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.init_state()
    rng = np.random.RandomState(4)
    for _ in range(2):
        tr.train_step(st, {"image": (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8),
                           "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)})
    jtr = JaxGANTrainer(jc, vae_variables=vae[0], mesh=make_mesh(devices=jax.devices()[:1]))
    return jc, tc, tr, st, jtr, tmp_path_factory.mktemp("bundles")


def test_port_bundle_reads_in_jax(trained):
    jc, tc, tr, st, jtr, tmp = trained
    path = str(tmp / "port.model")
    tr.save_model(st, path, epoch=4)
    bundle = convert.load_training_bundle(path)
    assert bundle["epoch"] == 5 and bundle["step"] == 2
    template = _jax_state(jtr, jc)
    js, epoch = import_torchgan_bundle(path, jc, template)
    assert epoch == 4
    m, r = tc.model, num_repeats(tc.model.out_size)
    for mod, jparams, jstats, opt, jopt, stats, net, n_bn in (
            (st.generator, js.g_params, js.g_stats, st.g_opt, js.g_opt, st.g_stats, "generator", r + 1),
            (st.discriminator, js.d_params, js.d_stats, st.d_opt, js.d_opt, st.d_stats,
             "discriminator", r)):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=0, atol=0)
        _close_stats(stats, _stats(jstats, n_bn), rtol=0, atol=0)
        assert int(jopt[0].count) == opt.count == 2
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        _close_list(opt.mu, mus, rtol=0, atol=0)
        _close_list(opt.nu, nus, rtol=0, atol=0)


def test_jax_bundle_reads_in_port(trained, vae):
    jc, tc, _, _, jtr, tmp = trained
    js = _jax_state(jtr, jc, seed=6)
    path = str(tmp / "jax.model")
    export_torchgan_bundle(path, jc, js, epoch=2)
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.load_model(path)
    m, r = tc.model, num_repeats(tc.model.out_size)
    assert st.step == 0  # JAX bundles carry no step: resume at 0, as the JAX importer does
    for mod, jparams, jstats, opt, jopt, stats, net, n_bn in (
            (st.generator, js.g_params, js.g_stats, st.g_opt, js.g_opt, st.g_stats, "generator", r + 1),
            (st.discriminator, js.d_params, js.d_stats, st.d_opt, js.d_opt, st.d_stats,
             "discriminator", r)):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=0, atol=0)
        _close_stats(stats, _stats(jstats, n_bn), rtol=0, atol=0)
        assert opt.count == int(jopt[0].count)
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        _close_list(opt.mu, mus, rtol=0, atol=0)
        _close_list(opt.nu, nus, rtol=0, atol=0)
    # and back: the port's moments in the flax layout are the JAX ones
    mu_tree, _ = convert.adam_moments_to_jax(m, "generator", st.g_opt.mu, st.g_opt.nu)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mu_tree, js.g_opt[0].mu)


def test_fit_writes_grid_and_bundle_and_resumes(vae, tmp_path):
    _, tc = _cfgs({"sample_size": 6}, {})
    rng = np.random.RandomState(8)
    data = [{"image": (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8),
             "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)} for _ in range(2)]
    img_dir, model_dir = str(tmp_path / "img"), str(tmp_path / "models")
    fid = {0: 5.0, 1: 7.0}
    tr = GANTrainer(tc, vae[1], device="cpu", image_dir=img_dir, model_dir=model_dir)
    state, out = tr.fit(lambda e: data, num_epochs=2, eval_fn=lambda e, s, t: {"fid": fid[e]},
                        eval_every=1, keep_best_metric="fid")
    assert state.step == 4 and len(out["history"]) == 2
    assert np.isfinite(out["history"][1]["d_loss"]) and out["history"][1]["fid"] == 7.0
    assert out["best"]["epoch"] == 0 and out["best"]["state"].step == 2
    with Image.open(os.path.join(img_dir, "epoch_1.png")) as im:
        assert im.size == (8 * 34 + 2, 34 + 2) and im.mode == "RGB"  # nrow=8, as the JAX grid
    assert os.path.exists(os.path.join(model_dir, "gan_best.model"))
    resumed = GANTrainer(tc, vae[1], device="cpu", model_dir=model_dir)
    state2, _ = resumed.fit(lambda e: data, num_epochs=1, auto_resume=True)
    assert state2.step == 6 and state2.g_opt.count == 6


def test_sample_modes(trained):
    _, _, tr, st, _, _ = trained
    gene = np.random.RandomState(9).randn(1, VAE_KW["rna_features"]).astype(F32)
    z_pop = (torch.zeros(MODEL_KW["encoding_dims"]), torch.ones(MODEL_KW["encoding_dims"]))
    for kw in ({}, {"gene": gene}, {"gene": gene, "z_pop": z_pop}):
        a = tr.sample(st, 5, seed=3, **kw)
        assert a.shape == (5, 32, 32, 3) and float(a.abs().max()) <= 1.0
        assert torch.equal(a, tr.sample(st, 5, seed=3, **kw))
    with pytest.raises(ValueError, match="EMA"):
        tr.sample(st, 2, use_ema=True)


# ----------------------------------------------------------------- images


@pytest.mark.parametrize("channels", [3, 1])
def test_png_grid_matches_pil(tmp_path, rng, channels):
    imgs = np.tanh(rng.randn(5, 7, 9, channels)).astype(F32)
    np.testing.assert_array_equal(timages.to_uint8(torch.from_numpy(imgs)), jimages.to_uint8(imgs))
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    timages.save_image_grid(torch.from_numpy(imgs), ours, nrow=3)
    jimages.save_image_grid(imgs, ref, nrow=3)
    with Image.open(ours) as a, Image.open(ref) as b:
        assert a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
