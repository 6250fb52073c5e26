"""SAGAN and BigGAN in the port against the JAX package, on the CPU at float32.

Configurations are the JAX tests' ``SAGAN16``/``BIGGAN16``
(``tests/test_attention_gans.py:18-21``). Weights are random flax trees with
the JAX nets' structure (``init_gan``'s shapes), every leaf drawn with
numpy, so the attention ``gamma`` and the conditional BatchNorm projections,
which start at 0, are not 0 here. Train
steps start from a step-5 state and take the JAX step's draws
(``test_torch_port_train_archs.py``'s recipe). Tolerances are that file's:
forward values and state 1e-5; parameters after a step rtol 1e-6 / atol
1e-7; metrics rtol 1e-4; Adam moments rtol 1e-4 plus 1e-5 of each tensor's
largest value; counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parity import jax_vae_variables
from test_torch_port_train import VAE_KW, _close_list, _np

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.models.biggan import split_latent as jsplit_latent
from rnagan_tpu.models.dcgan import init_gan
from rnagan_tpu.models.dcgan import make_discriminator as jmake_discriminator
from rnagan_tpu.models.dcgan import make_generator as jmake_generator
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu.train.gan_trainer import GANTrainState as JaxState
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.models.biggan import BigGANGenerator, split_latent
from rnagan_tpu_torch.models.registry import make_discriminator, make_generator
from rnagan_tpu_torch.models.sagan import spectral_norm
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

F32 = np.float32
N = 4
SAGAN16 = dict(arch="sagan", encoding_dims=16, out_size=16, step_channels=4, attn_size=8,
               compute_dtype="float32")
BIGGAN16 = dict(arch="biggan", encoding_dims=24, out_size=16, step_channels=4, num_classes=2,
                attn_size=8, embed_dim=6, compute_dtype="float32")
MODELS = {"sagan": SAGAN16, "biggan": BIGGAN16, "biggan_unconditional": {**BIGGAN16, "num_classes": 0}}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(name, **kw):
    m = {**MODELS[name], **kw}
    return jcfg.GANModelConfig(**m), tcfg.GANModelConfig(**m)


def _leaf(rng, path, a):
    """A random leaf for the parameter at ``path`` shaped like ``a``."""
    names = [getattr(k, "key", "") for k in path]
    if a.ndim == 0:  # attention gamma
        return np.asarray(0.5 + 0.2 * rng.randn(), F32)
    if names[-1] == "kernel":
        fan_in = int(np.prod(a.shape[:-1]))
        scale = 0.3 if names[-2] in ("gamma", "beta") else 1.0  # the CBN projections
        return (scale * rng.randn(*a.shape) / np.sqrt(fan_in)).astype(F32)
    if names[-1] == "scale":
        return (1.0 + 0.1 * rng.randn(*a.shape)).astype(F32)
    if names[-1] == "embedding":
        return rng.randn(*a.shape).astype(F32)
    return (0.1 * rng.randn(*a.shape)).astype(F32)  # biases


def _stat(rng, path, a):
    name = getattr(path[-1], "key", "")
    if name == "mean":
        return (0.2 * rng.randn(*a.shape)).astype(F32)
    if name == "var":
        return (1.0 + rng.rand(*a.shape)).astype(F32)
    if name.endswith("/u"):  # flax draws u standard normal
        return rng.randn(*a.shape).astype(F32)
    return np.ones(a.shape, F32)  # sigma, 1 at init (it normalizes nothing)


def jax_variables(jm, seed=0):
    """``((g_params, g_stats), (d_params, d_stats))``: numpy trees with the
    JAX nets' structure (``init_gan``'s shapes), every parameter random,
    BatchNorm statistics random, spectral norm's ``u`` drawn as flax draws it."""
    rng = np.random.RandomState(seed)
    gv, dv = jax.eval_shape(lambda k: init_gan(jm, k), jax.random.key(seed))
    out = []
    for v in (gv, dv):
        params = jax.tree_util.tree_map_with_path(lambda p, a: _leaf(rng, p, a), v["params"])
        stats = jax.tree_util.tree_map_with_path(lambda p, a: _stat(rng, p, a), v.get("batch_stats", {}))
        out.append((params, stats))
    return out


def _port_net(tm, net, params, stats):
    module = (make_generator if net == "generator" else make_discriminator)(tm)
    sd = (convert.generator_state_dict_from_jax if net == "generator"
          else convert.discriminator_state_dict_from_jax)(tm, params, stats)
    module.load_state_dict(sd)
    return module


def _close_stats(got, ref, rtol=1e-5, atol=1e-6):
    assert len(got) == len(ref)
    for pair, ref_pair in zip(got, ref):
        for g, r in zip(pair, ref_pair):
            np.testing.assert_allclose(_np(g), _np(r), rtol=rtol, atol=atol)


def _labels(jm):
    return np.array([0, 1, 1, 0][:N], np.int32) if jm.num_classes else None


# ---------------------------------------------------------------- forwards


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_forwards_and_state_match_jax(rng, name, train):
    """G and D against flax in train and eval mode: outputs, and the state
    they return (BatchNorm statistics and spectral norm's ``u``/``sigma``;
    eval mode runs the power iteration and returns the state unchanged)."""
    jm, tm = _models(name)
    (gp, gs), (dp, ds) = jax_variables(jm, seed=3)
    labels = _labels(jm)
    jl = None if labels is None else jnp.asarray(labels)
    tl = None if labels is None else torch.from_numpy(labels)
    z = rng.randn(N, jm.encoding_dims).astype(F32)
    x = rng.randn(N, 16, 16, 3).astype(F32)
    for net, params, stats, inp in (("generator", gp, gs, z), ("discriminator", dp, ds, x)):
        jnet = (jmake_generator if net == "generator" else jmake_discriminator)(jm)
        apply = jax.jit(lambda v, x, y: jnet.apply(v, x, labels=y, train=train, mutable=["batch_stats"]))
        ref, upd = apply({"params": params, "batch_stats": stats}, jnp.asarray(inp), jl)
        port = _port_net(tm, net, params, stats)
        if net == "generator":
            got, new = port.forward_stats(torch.from_numpy(inp), port.bn_stats(), train, labels=tl)
            got = got.permute(0, 2, 3, 1)
        else:
            got, new = port(torch.from_numpy(inp).permute(0, 3, 1, 2), port.bn_stats(), train, labels=tl)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=net)
        _close_stats(new, _port_net(tm, net, params, upd["batch_stats"]).bn_stats())
        if not train:
            assert all(a is b for pair, old in zip(new, port.bn_stats()) for a, b in zip(pair, old))


def test_spectral_norm_is_flax_power_iteration(rng):
    """One kernel of each layout through ``spectral_norm`` against flax
    ``nn.SpectralNorm`` around the same layer: the new ``u`` and ``sigma``,
    the layer's output, and the kernel's gradient (which flows through
    ``sigma`` too)."""
    import torch.nn.functional as F
    from flax import linen as nn

    x = rng.randn(2, 5, 5, 6).astype(F32)
    layers = {"conv": (nn.Conv(4, (3, 3), use_bias=False), convert.conv_kernel_to_torch,
                       lambda t, w: F.conv2d(t, w, padding=1)),
              "convt": (nn.ConvTranspose(4, (3, 3), use_bias=False), convert.convt_kernel_to_torch,
                        lambda t, w: F.conv_transpose2d(t, w, padding=1)),
              "dense": (nn.Dense(4, use_bias=False), lambda k: torch.from_numpy(np.ascontiguousarray(k.T)),
                        lambda t, w: F.linear(t, w))}
    for kind, (layer, to_torch, apply) in layers.items():
        sn = nn.SpectralNorm(layer, collection_name="batch_stats")
        xin = x[:, 0, 0, :] if kind == "dense" else x
        v = sn.init(jax.random.key(1), jnp.asarray(xin), update_stats=False)
        kernel = rng.randn(*v["params"]["layer_instance"]["kernel"].shape).astype(F32)
        u = np.array(v["batch_stats"]["layer_instance/kernel/u"])

        def loss(k):
            out, upd = sn.apply({"params": {"layer_instance": {"kernel": k}}, "batch_stats": v["batch_stats"]},
                                jnp.asarray(xin), update_stats=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, upd["batch_stats"])

        (_, (ref, new)), ref_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(kernel))
        w = to_torch(kernel).requires_grad_()
        wn, u_new, sigma = spectral_norm(w, torch.from_numpy(u), kind)
        np.testing.assert_allclose(_np(u_new), np.asarray(new["layer_instance/kernel/u"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(sigma), float(new["layer_instance/kernel/sigma"]), rtol=1e-6)
        assert not u_new.requires_grad and not sigma.requires_grad
        t = torch.from_numpy(xin if kind == "dense" else xin.transpose(0, 3, 1, 2).copy())
        out = apply(t, wn)
        got = out if kind == "dense" else out.permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
        (grad,) = torch.autograd.grad((out ** 2).sum(), w)
        _close_list([grad], [to_torch(np.asarray(ref_grad))], rtol=1e-4, atol=1e-6, scaled=1e-5)


def test_sigma_tracks_true_singular_value():
    """After 30 updating forwards a SAGAN discriminator kernel's stored
    ``sigma`` is within 5 % of its top singular value
    (``tests/test_attention_gans.py:72-92``)."""
    _, tm = _models("sagan")
    d = make_discriminator(tm, seed=1)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 16, 16).astype(F32))
    stats = d.bn_stats()
    with torch.no_grad():
        for _ in range(30):
            _, stats = d(x, stats, True)
    w = d.Conv_1.weight.detach()
    true_sigma = float(torch.linalg.matrix_norm(w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]), 2))
    np.testing.assert_allclose(float(stats[d.Conv_1.slot][1]), true_sigma, rtol=0.05)


def test_biggan_latent_split():
    z = np.arange(2 * 2048, dtype=F32).reshape(2, 2048)
    got = split_latent(torch.from_numpy(z), 7)
    assert [c.shape[-1] for c in got] == [293, 293, 293, 293, 292, 292, 292]
    for a, b in zip(got, jsplit_latent(jnp.asarray(z), 7), strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_biggan_conditioning_and_labels(rng):
    """At init the conditional BatchNorm is plain BatchNorm (labels change
    nothing); with its projections randomized they do; a conditional
    generator without labels refuses, as the JAX net fails."""
    _, tm = _models("biggan")
    g = BigGANGenerator(tm, seed=2).eval()
    z = torch.from_numpy(rng.randn(2, 24).astype(F32))
    a, b = g(z, torch.tensor([0, 0])), g(z, torch.tensor([1, 1]))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        g.block_0.cbn1.gamma.weight.normal_(0, 0.5)
    assert not torch.allclose(g(z, torch.tensor([0, 0])), g(z, torch.tensor([1, 1])), atol=1e-4)
    with pytest.raises(ValueError, match="labels"):
        g(z)
    _, unc = _models("biggan_unconditional")
    assert not hasattr(make_generator(unc), "shared_embed")
    assert not hasattr(make_discriminator(unc), "proj_embed")


@pytest.mark.parametrize("name", ["sagan", "biggan"])
def test_param_paths_cover_the_flax_tree(name):
    """``param_paths`` names every flax parameter once, in the port's
    ``parameters()`` order, with the port's shapes after the layout transform."""
    jm, tm = _models(name)
    shapes = jax.eval_shape(lambda k: init_gan(jm, k), jax.random.key(0))
    for net, variables in (("generator", shapes[0]), ("discriminator", shapes[1])):
        flat = {tuple(k.key for k in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
        paths = convert.param_paths(tm, net)
        assert sorted(p for p, _ in paths) == sorted(flat)
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, F32), variables["params"])
        module = (make_generator if net == "generator" else make_discriminator)(tm)
        assert [t.shape for t in convert.param_list_from_jax(tm, net, tree)] == \
            [p.shape for p in module.parameters()]


# -------------------------------------------------------------- train steps


def _vae_kw(jm):
    return {**VAE_KW, "z_dim": jm.encoding_dims}


@pytest.fixture(scope="module")
def vaes():
    """A frozen VAE for each net's noise width: z_dim -> (JAX variables, port state_dict)."""
    out = {}
    for name in ("sagan", "biggan"):
        kw = _vae_kw(_models(name)[0])
        vars_ = jax_vae_variables(jcfg.VAEModelConfig(**kw), seed=11)
        out[kw["z_dim"]] = vars_, convert.betavae_state_dict_from_jax(tcfg.VAEModelConfig(**kw), vars_)
    return out


def _cfgs(name, cfg_kw=None, **model_kw):
    jm, tm = _models(name, **model_kw)
    cfg_kw = cfg_kw or {}
    return (jcfg.GANConfig(model=jm, vae=jcfg.VAEModelConfig(**_vae_kw(jm)), batch_size=N, **cfg_kw),
            tcfg.GANConfig(model=tm, vae=tcfg.VAEModelConfig(**_vae_kw(jm)), batch_size=N, **cfg_kw))


def _jax_state(jtr, jc, seed=0):
    """A JAX ``GANTrainState`` at step 5 (G's Adam count 5, D's 7)."""
    rng = np.random.RandomState(seed)
    (g_params, g_stats), (d_params, d_stats) = jax_variables(jc.model, seed + 1)

    def opt(tx, params, count):
        st = tx.init(params)
        mu = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape) * 1e-3, jnp.float32), params)
        nu = jax.tree_util.tree_map(lambda p: np.asarray(rng.rand(*p.shape) + 0.5, F32) * 1e-2, params)
        return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])

    return JaxState(step=jnp.asarray(5, jnp.int32), g_params=g_params, g_stats=g_stats,
                    g_opt=opt(jtr.g_tx, g_params, 5), d_params=d_params, d_stats=d_stats,
                    d_opt=opt(jtr.d_tx, d_params, 7), g_ema=None)


def _port_state(tr, tc, js):
    """The port's state holding exactly the JAX state ``js``."""
    m = tc.model
    st = tr.init_state()
    st.generator.load_state_dict(convert.generator_state_dict_from_jax(m, js.g_params, js.g_stats))
    st.discriminator.load_state_dict(convert.discriminator_state_dict_from_jax(m, js.d_params, js.d_stats))
    st.g_stats = [(a.clone(), b.clone()) for a, b in st.generator.bn_stats()]
    st.d_stats = [(a.clone(), b.clone()) for a, b in st.discriminator.bn_stats()]
    for opt, jopt, net in ((st.g_opt, js.g_opt, "generator"), (st.d_opt, js.d_opt, "discriminator")):
        opt.mu, opt.nu = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        opt.count = int(jopt[0].count)
    st.step = int(js.step)
    return st


def _draws(key, jc):
    """The stage draws of the JAX ``_train_step_impl`` for the batch key ``key``."""
    k_d, k_gp, k_g, k_eps = (jax.random.fold_in(key, i) for i in range(4))
    shape = (N, jc.model.encoding_dims)
    if jc.loss_type == "wganvae":
        draw = lambda k: jax.random.uniform(k, shape, jnp.float32, -jc.noise_range, jc.noise_range)  # noqa: E731
    else:
        draw = lambda k: jax.random.normal(k, shape, jnp.float32)  # noqa: E731
    eps_shape = () if jc.compat_reference_gp else (N, 1, 1, 1)
    return {"u_d": np.asarray(draw(k_d)), "u_gp": np.asarray(draw(k_gp)),
            "u_g": np.asarray(draw(k_g)), "eps": np.asarray(jax.random.uniform(k_eps, eps_shape))}


def _batch(rng, jm):
    batch = {"image": (rng.rand(N, 16, 16, 3) * 2 - 1).astype(F32),
             "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
    if jm.num_classes:
        batch["labels"] = rng.randint(0, jm.num_classes, N).astype(np.int32)
    return batch


#: name -> (model, GANConfig fields, GANModelConfig fields)
CASES = {
    "sagan": ("sagan", {}, {}),
    "sagan_compat_reference_gp": ("sagan", {"compat_reference_gp": True}, {}),
    "biggan": ("biggan", {}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(vaes, case):
    """One wganvae step from a step-5 state with the JAX step's draws:
    metrics, parameters, the state pairs and Adam's moments and counts."""
    name, cfg_kw, model_kw = CASES[case]
    jc, tc = _cfgs(name, cfg_kw, **model_kw)
    vae_vars, vae_sd = vaes[jc.model.encoding_dims]
    jtr = JaxGANTrainer(jc, vae_variables=vae_vars, mesh=make_mesh(devices=jax.devices()[:1]))
    js = _jax_state(jtr, jc)
    tr = GANTrainer(tc, vae_sd, device="cpu")
    ts = _port_state(tr, tc, js)
    batch = _batch(np.random.RandomState(1), jc.model)
    key = jax.random.key(300)
    js, jmet = jtr._train_step(js, {**batch, "rng": key}, jtr.vae_variables)
    ts, tmet = tr.train_step(ts, batch, draws=_draws(key, jc))
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    m = tc.model
    assert ts.step == int(js.step) == 6
    for mod, jparams, jstats, stats, opt, jopt, net in (
            (ts.generator, js.g_params, js.g_stats, ts.g_stats, ts.g_opt, js.g_opt, "generator"),
            (ts.discriminator, js.d_params, js.d_stats, ts.d_stats, ts.d_opt, js.d_opt, "discriminator")):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=1e-6, atol=1e-7)
        _close_stats(stats, _port_net(m, net, jparams, jstats).bn_stats())
        assert opt.count == int(jopt[0].count)
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        _close_list(opt.mu, mus, rtol=1e-4, atol=1e-7, scaled=1e-5)
        _close_list(opt.nu, nus, rtol=1e-4, atol=1e-9, scaled=1e-5)


@pytest.mark.parametrize("name", ["biggan", "biggan_unconditional"])
def test_biggan_remat_is_bit_equal(vaes, name):
    """``remat=True`` changes the schedule, not the math: a wganvae step
    (D stage with the fused GP's double backward through the recomputed
    blocks, G stage) gives bit-equal metrics, parameters, state and moments."""
    runs = []
    for remat in (False, True):
        _, tc = _cfgs(name, remat=remat)
        tr = GANTrainer(tc, vaes[tc.model.encoding_dims][1], device="cpu")
        st = tr.init_state()
        with torch.no_grad():  # the attention gate and the CBN projections start at 0
            for p in st.generator.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        batch = _batch(np.random.RandomState(5), tc.model)
        st, met = tr.train_step(st, batch)
        runs.append((st, met))
    (a, ma), (b, mb) = runs
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in ((a.generator, b.generator), (a.discriminator, b.discriminator)):
        assert all(torch.equal(p, q) for p, q in zip(x.parameters(), y.parameters(), strict=True))
    for s, t in ((a.g_stats, b.g_stats), (a.d_stats, b.d_stats)):
        assert all(torch.equal(x, y) for u, w in zip(s, t, strict=True) for x, y in zip(u, w))
    assert all(torch.equal(x, y) for x, y in zip(a.d_opt.mu + a.d_opt.nu, b.d_opt.mu + b.d_opt.nu))


def test_fused_critic_batch_rejected_for_sn_archs(vaes):
    for name in ("sagan", "biggan"):
        jc, tc = _cfgs(name, {"fused_critic_batch": True})
        vae = vaes[jc.model.encoding_dims]
        with pytest.raises(ValueError, match="spectral-norm"):
            JaxGANTrainer(jc, vae_variables=vae[0], mesh=make_mesh(devices=jax.devices()[:1]))
        with pytest.raises(ValueError, match="spectral-norm"):
            GANTrainer(tc, vae[1], device="cpu")


def test_labels_required_and_sampled(vaes):
    _, tc = _cfgs("biggan")
    tr = GANTrainer(tc, vaes[tc.model.encoding_dims][1], device="cpu")
    st = tr.init_state()
    batch = _batch(np.random.RandomState(4), tc.model)
    del batch["labels"]
    with pytest.raises(ValueError, match="labels"):
        tr.train_step(st, batch)
    a = tr.sample(st, 5, seed=2)
    assert a.shape == (5, 16, 16, 3) and torch.equal(a, tr.sample(st, 5, seed=2))
    given = tr.sample(st, 5, seed=2, labels=[1, 1, 1, 1, 1])
    assert torch.equal(given, tr.sample(st, 5, seed=2, labels=np.ones(5, np.int64)))


# ----------------------------------------------------------------- bundles


@pytest.mark.parametrize("name", ["sagan", "biggan"])
def test_bundle_round_trip(vaes, tmp_path, name):
    """``save_model`` -> ``load_model``: parameters, the state pairs
    (spectral norm's included), Adam's moments and counts, the step."""
    _, tc = _cfgs(name)
    vae = vaes[tc.model.encoding_dims]
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.init_state()
    rng = np.random.RandomState(3)
    for _ in range(2):
        tr.train_step(st, _batch(rng, tc.model))
    path = str(tmp_path / "gan.model")
    tr.save_model(st, path, epoch=1)
    back = GANTrainer(tc, vae[1], device="cpu").load_model(path)
    assert back.step == st.step == 2 and type(back.generator) is type(st.generator)
    for a, b in ((st.generator, back.generator), (st.discriminator, back.discriminator)):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters(), strict=True))
    for s, t in ((st.g_stats, back.g_stats), (st.d_stats, back.d_stats)):
        assert all(torch.equal(x, y) for u, w in zip(s, t, strict=True) for x, y in zip(u, w))
    for o, q in ((st.g_opt, back.g_opt), (st.d_opt, back.d_opt)):
        assert o.count == q.count == 2
        assert all(torch.equal(x, y) for x, y in zip(o.mu + o.nu, q.mu + q.nu, strict=True))


@pytest.mark.parametrize("name", ["sagan", "biggan"])
def test_jax_bundle_loads_through_state_from_jax(vaes, tmp_path, name):
    """The JAX trainer's own msgpack bundle, spectral-norm state with its
    slashed keys included, read by the port's ``load_model``."""
    jc, tc = _cfgs(name)
    vae = vaes[jc.model.encoding_dims]
    jtr = JaxGANTrainer(jc, vae_variables=vae[0], mesh=make_mesh(devices=jax.devices()[:1]))
    js = _jax_state(jtr, jc, seed=6)
    path = str(tmp_path / "jax.model")
    jtr.save_model(js, path)
    jtr._saver.wait()
    st = GANTrainer(tc, vae[1], device="cpu").load_model(path)
    m = tc.model
    assert st.step == 5 and st.g_opt.count == 5 and st.d_opt.count == 7
    for mod, jparams, jstats, stats, opt, jopt, net in (
            (st.generator, js.g_params, js.g_stats, st.g_stats, st.g_opt, js.g_opt, "generator"),
            (st.discriminator, js.d_params, js.d_stats, st.d_stats, st.d_opt, js.d_opt, "discriminator")):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=0, atol=0)
        _close_stats(stats, _port_net(m, net, jparams, jstats).bn_stats(), rtol=0, atol=0)
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        _close_list(opt.mu + opt.nu, mus + nus, rtol=0, atol=0)
    assert any(k.endswith("sn_u") for k in st.discriminator.state_dict())


def test_sn_nets_train_through_fit(vaes, tmp_path):
    """``fit`` for both archs: finite losses, and the parameters move."""
    for name in ("sagan", "biggan"):
        _, tc = _cfgs(name, {"sample_size": 4})
        vae = vaes[tc.model.encoding_dims]
        rng = np.random.RandomState(5)
        data = [_batch(rng, tc.model) for _ in range(2)]
        tr = GANTrainer(tc, vae[1], device="cpu", model_dir=str(tmp_path / name))
        init = [p.detach().clone() for p in tr.init_state().generator.parameters()]
        state, out = tr.fit(lambda e: data, num_epochs=1)
        assert state.step == 2 and np.isfinite(out["history"][0]["d_loss"])
        moved = [float((p.detach() - q).abs().max()) for p, q in zip(state.generator.parameters(), init)]
        assert max(moved) > 1e-6
