"""Training ``dcgan_up`` and ``condgan`` in the port against the JAX package,
on the CPU at float32.

Modelled on ``test_torch_port_train.py::test_train_step_matches_jax``: both
packages start from one step-5 state (the weights as numpy trees in the flax
layout, Adam moments random with ``nu`` far above ``(1-b2)*g^2``), take the
same batches, ``condgan``'s labels included, and the same stage draws, which
the JAX step reads from the batch's ``"rng"`` key and the port takes as
``draws``. Tolerances are that test's: parameters rtol 1e-6 / atol 1e-7,
BatchNorm statistics 1e-5, metrics rtol 1e-4, Adam moments rtol 1e-4 plus
1e-5 of each tensor's largest value, counts exactly. ``dcgan_up``'s conv
biases ahead of a BatchNorm have a gradient that is mathematically 0; their
moments are held to 1e-5 of their conv kernel's (``_grad_scale``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parity import jax_generator_variables
from test_torch_port_serving import jax_up_generator_variables
from test_torch_port_train import (VAE_KW, _close_list, _close_stats, _draws, _np, _port_state, _stats,
                                   jax_discriminator_variables, vae)  # noqa: F401 (a fixture)

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.models.dcgan import init_gan
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu.train.gan_trainer import GANTrainState as JaxState
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.models.dcgan import (ConditionalDCGANDiscriminator, ConditionalDCGANGenerator,
                                           DCGANDiscriminator, DCGANUpGenerator, num_repeats)
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

F32 = np.float32
N = 4
NUM_CLASSES = 3
MODEL_KW = dict(out_size=32, encoding_dims=32, step_channels=8, compute_dtype="float32")


def _cfgs(arch, cfg_kw=None, **model_kw):
    kw = {**MODEL_KW, "arch": arch, "num_classes": NUM_CLASSES if arch == "condgan" else 0, **model_kw}
    jm, tm = jcfg.GANModelConfig(**kw), tcfg.GANModelConfig(**kw)
    cfg_kw = cfg_kw or {}
    return (jcfg.GANConfig(model=jm, vae=jcfg.VAEModelConfig(**VAE_KW), batch_size=N, **cfg_kw),
            tcfg.GANConfig(model=tm, vae=tcfg.VAEModelConfig(**VAE_KW), batch_size=N, **cfg_kw))


def _variables(m, seed):
    """Random flax-layout G and D variables of ``m``'s arch."""
    if m.arch == "dcgan_up":
        g = jax_up_generator_variables(m, seed)
    else:  # condgan's head reads the one-hot too
        g = jax_generator_variables(dataclasses.replace(m, encoding_dims=m.encoding_dims + m.num_classes), seed)
    d = jax_discriminator_variables(dataclasses.replace(m, out_channels=m.out_channels + m.num_classes), seed + 1)
    return g, d


def _jax_state(jtr, jc, seed=0):
    """A JAX ``GANTrainState`` at step 5 (G's Adam count 5, D's 7)."""
    rng = np.random.RandomState(seed)
    (g_params, g_stats), (d_params, d_stats) = _variables(jc.model, seed + 1)

    def opt(tx, params, count):
        st = tx.init(params)
        mu = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape) * 1e-3, jnp.float32), params)
        nu = jax.tree_util.tree_map(lambda p: (rng.rand(*p.shape) + 0.5).astype(F32) * 1e-2, params)
        return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])

    return JaxState(step=jnp.asarray(5, jnp.int32), g_params=g_params, g_stats=g_stats,
                    g_opt=opt(jtr.g_tx, g_params, 5), d_params=d_params, d_stats=d_stats,
                    d_opt=opt(jtr.d_tx, d_params, 7), g_ema=None)


def _batch(rng, arch):
    batch = {"image": (rng.rand(N, 32, 32, 3) * 2 - 1).astype(F32),
             "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
    if arch == "condgan":
        batch["labels"] = rng.randint(0, NUM_CLASSES, N).astype(np.int32)
    return batch


#: name -> (arch, GANConfig fields, steps)
CASES = {
    "dcgan_up": ("dcgan_up", {}, 1),
    "dcgan_up_compat_reference_gp": ("dcgan_up", {"compat_reference_gp": True}, 1),
    "dcgan_up_lsgan": ("dcgan_up", {"loss_type": "lsgan"}, 1),
    "condgan": ("condgan", {}, 1),
    "condgan_compat_reference_gp": ("condgan", {"compat_reference_gp": True}, 1),
    "condgan_wgan_clip_n_critic_2": ("condgan", {"loss_type": "wgan", "n_critic": 2}, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(vae, case):
    arch, cfg_kw, steps = CASES[case]
    jc, tc = _cfgs(arch, cfg_kw)
    vae_vars, vae_sd = vae
    wganvae = jc.loss_type == "wganvae"
    jtr = JaxGANTrainer(jc, vae_variables=vae_vars if wganvae else None,
                        mesh=make_mesh(devices=jax.devices()[:1]))
    js = _jax_state(jtr, jc)
    tr = GANTrainer(tc, vae_sd if wganvae else None, device="cpu")
    ts = _port_state(tr, tc, js)
    rng = np.random.RandomState(1)
    for k in range(steps):
        batch = _batch(rng, arch)
        key = jax.random.key(200 + k)
        js, jmet = jtr._train_step(js, {**batch, "rng": key}, jtr.vae_variables)
        ts, tmet = tr.train_step(ts, batch, draws=_draws(key, jc))
        assert set(tmet) == set(jmet)
        for name in jmet:
            np.testing.assert_allclose(_np(tmet[name]), np.asarray(jmet[name]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {k} {name}")
    m, r = tc.model, num_repeats(tc.model.out_size)
    assert ts.step == int(js.step) == 5 + steps
    for mod, jparams, jstats, stats, opt, jopt, net, n_bn in (
            (ts.generator, js.g_params, js.g_stats, ts.g_stats, ts.g_opt, js.g_opt, "generator", r + 1),
            (ts.discriminator, js.d_params, js.d_stats, ts.d_stats, ts.d_opt, js.d_opt, "discriminator", r)):
        _close_list(list(mod.parameters()), convert.param_list_from_jax(m, net, jparams), rtol=1e-6, atol=1e-7)
        _close_stats(stats, _stats(jstats, n_bn))
        assert opt.count == int(jopt[0].count)
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        names = [name for name, _ in mod.named_parameters()]
        for got, ref, atol in ((opt.mu, mus, 1e-7), (opt.nu, nus, 1e-9)):
            for name, g, r_ in zip(names, got, ref, strict=True):
                _close_list([g], [r_], rtol=1e-4, atol=atol + 1e-5 * _grad_scale(name, names, ref))


def _grad_scale(name, names, moments):
    """The magnitude a moment's rounding acts on: its own tensor's largest
    value, except for a bias that a train-mode BatchNorm follows
    (``dcgan_up``'s ``model.<b>.0.bias``, b = 1..r). BatchNorm subtracts the
    batch mean, so that bias's gradient is 0 and both packages compute
    rounding noise of the sums behind its conv's kernel gradient: its scale
    is that kernel's moment."""
    i = names.index(name)
    if name.endswith(".0.bias") and name.replace(".0.bias", ".1.weight") in names:
        i = names.index(name.replace(".bias", ".weight"))
    return float(moments[i].abs().max())


@pytest.mark.parametrize("arch,batchnorm", [("dcgan_up", True), ("dcgan_up", False), ("condgan", True)])
def test_param_paths_cover_the_flax_tree(arch, batchnorm):
    """``param_paths`` names every flax parameter once, in the port's
    ``parameters()`` order, with the port's shapes after the layout transform."""
    jc, tc = _cfgs(arch, batchnorm=batchnorm)
    shapes = jax.eval_shape(lambda k: init_gan(jc.model, k), jax.random.key(0))
    gen_cls = DCGANUpGenerator if arch == "dcgan_up" else ConditionalDCGANGenerator
    dis_cls = DCGANDiscriminator if arch == "dcgan_up" else ConditionalDCGANDiscriminator
    for net, variables, module in (("generator", shapes[0], gen_cls(tc.model)),
                                   ("discriminator", shapes[1], dis_cls(tc.model))):
        flat = {tuple(k.key for k in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
        paths = convert.param_paths(tc.model, net)
        assert sorted(p for p, _ in paths) == sorted(flat)
        zeros = {p: np.zeros(s, F32) for p, s in flat.items()}
        tree = {}
        for p, a in zeros.items():
            node = tree
            for key in p[:-1]:
                node = node.setdefault(key, {})
            node[p[-1]] = a
        got = [t.shape for t in convert.param_list_from_jax(tc.model, net, tree)]
        assert got == [p.shape for p in module.parameters()]


@pytest.mark.parametrize("arch", ["dcgan_up", "condgan"])
def test_bundle_round_trip(vae, tmp_path, arch):
    """``save_model`` -> ``load_model`` gives back the training state exactly:
    parameters, statistics, Adam moments and counts, the step; and the
    moments leave in the flax layout as they came."""
    jc, tc = _cfgs(arch)
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.init_state()
    rng = np.random.RandomState(3)
    for _ in range(2):
        tr.train_step(st, _batch(rng, arch))
    path = str(tmp_path / "gan.model")
    tr.save_model(st, path, epoch=1)
    back = GANTrainer(tc, vae[1], device="cpu").load_model(path)
    assert back.step == st.step == 2 and type(back.generator) is type(st.generator)
    for a, b in ((st.generator, back.generator), (st.discriminator, back.discriminator)):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters(), strict=True))
    for s, t in ((st.g_stats, back.g_stats), (st.d_stats, back.d_stats)):
        assert all(torch.equal(x, y) for u, w in zip(s, t, strict=True) for x, y in zip(u, w))
    for o, q, net in ((st.g_opt, back.g_opt, "generator"), (st.d_opt, back.d_opt, "discriminator")):
        assert o.count == q.count == 2
        assert all(torch.equal(x, y) for x, y in zip(o.mu + o.nu, q.mu + q.nu, strict=True))
        mu_tree, nu_tree = convert.adam_moments_to_jax(tc.model, net, q.mu, q.nu)
        mus, nus = convert.adam_moments_from_jax(tc.model, net, mu_tree, nu_tree)
        assert all(torch.equal(x, y) for x, y in zip(mus + nus, q.mu + q.nu, strict=True))


def test_condgan_needs_labels_and_samples_them(vae):
    _, tc = _cfgs("condgan")
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.init_state()
    batch = _batch(np.random.RandomState(4), "condgan")
    del batch["labels"]
    with pytest.raises(ValueError, match="labels"):
        tr.train_step(st, batch)
    a = tr.sample(st, 5, seed=2)  # noise and labels from generators of the seed
    assert a.shape == (5, 32, 32, 3) and torch.equal(a, tr.sample(st, 5, seed=2))
    assert not torch.equal(a, tr.sample(st, 5, seed=3))


def test_fit_trains_both_archs(vae, tmp_path):
    """``fit`` passes each batch, its labels included, to the step."""
    for arch in ("dcgan_up", "condgan"):
        _, tc = _cfgs(arch, {"sample_size": 4})
        rng = np.random.RandomState(5)
        data = [_batch(rng, arch) for _ in range(2)]
        tr = GANTrainer(tc, vae[1], device="cpu", model_dir=str(tmp_path / arch))
        state, out = tr.fit(lambda e: data, num_epochs=1)
        assert state.step == 2 and np.isfinite(out["history"][0]["d_loss"])
