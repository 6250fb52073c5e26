"""The PyTorch port against the JAX package on the CPU, at float32.

Both packages get the same weights (numpy trees in the JAX layout, carried
across by the port's converters) and the same inputs and uniforms (drawn
once, with numpy or ``jax.random``, and handed to both). BatchNorm running
statistics are random and far from (0, 1), so folding is exercised.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.eval.serving import dcgan_lax_apply, fold_generator, make_serving_fn
from rnagan_tpu.losses import rna_infusion as jinf
from rnagan_tpu.models.betavae import BetaVAE as JaxBetaVAE
from rnagan_tpu.models.dcgan import make_generator
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.eval import serving as tserving
from rnagan_tpu_torch.eval.generate import Synthesizer
from rnagan_tpu_torch.losses import rna_infusion as tinf
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.models.dcgan import DCGANGenerator

VAE_KW = dict(rna_features=256, z_dim=64, encoder_dims=(128, 96, 64), decoder_dims=(96, 128),
              compute_dtype="float32")
GAN_KW = dict(out_size=64, encoding_dims=64, step_channels=8, compute_dtype="float32")
NOISE_RANGE = 0.3


def _bn(rng, width):
    params = {"scale": (1.0 + 0.1 * rng.randn(width)).astype(np.float32),
              "bias": (0.1 * rng.randn(width)).astype(np.float32)}
    stats = {"mean": (0.2 * rng.randn(width)).astype(np.float32),
             "var": (1.0 + rng.rand(width)).astype(np.float32)}
    return params, stats


def _dense(rng, fan_in, width):
    return {"kernel": (rng.randn(fan_in, width) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.1 * rng.randn(width)).astype(np.float32)}


def jax_vae_variables(cfg, seed=0):
    """Random ``BetaVAE`` variables in the flax tree layout."""
    rng = np.random.RandomState(seed)
    params = {"encoder": {}, "decoder": {}}
    stats = {"encoder": {}, "decoder": {}}
    fan_in = cfg.rna_features
    for i, w in enumerate(cfg.encoder_dims):
        params["encoder"][f"dense_{i}"] = _dense(rng, fan_in, w)
        params["encoder"][f"bn_{i}"], stats["encoder"][f"bn_{i}"] = _bn(rng, w)
        fan_in = w
    params["z_mu"] = _dense(rng, fan_in, cfg.z_dim)
    params["z_logvar"] = _dense(rng, fan_in, cfg.z_dim)
    fan_in = cfg.z_dim
    for i, w in enumerate(cfg.decoder_dims):
        params["decoder"][f"dense_{i}"] = _dense(rng, fan_in, w)
        params["decoder"][f"bn_{i}"], stats["decoder"][f"bn_{i}"] = _bn(rng, w)
        fan_in = w
    params["decoder"]["dense_out"] = _dense(rng, fan_in, cfg.rna_features)
    return {"params": params, "batch_stats": stats}


def jax_generator_variables(cfg, seed=0):
    """Random ``DCGANGenerator`` params/batch_stats in the flax tree layout,
    scaled so the pre-tanh output spans the whole uint8 range."""
    rng = np.random.RandomState(seed)
    r = cfg.out_size.bit_length() - 4
    chans = [cfg.encoding_dims] + [cfg.step_channels * 2 ** (r - b) for b in range(r + 1)]
    chans.append(cfg.out_channels)
    params, stats = {}, {}
    for b in range(r + 2):
        cin, cout = chans[b], chans[b + 1]
        taps = 1 if b == 0 else 4  # output pixel of a 1x1-input head vs a stride-2 4x4
        leaf = {"kernel": (rng.randn(4, 4, cin, cout) / np.sqrt(cin * taps)).astype(np.float32)}
        if b == r + 1 or not cfg.batchnorm:
            leaf["bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
        params[f"ConvTranspose_{b}"] = leaf
        if cfg.batchnorm and b <= r:
            bp, bs = _bn(rng, cout)
            params[f"_BN_{b}"] = {"BatchNorm_0": bp}
            stats[f"_BN_{b}"] = {"BatchNorm_0": bs}
    return params, stats


@pytest.fixture(scope="module")
def weights():
    jv_cfg, jg_cfg = jcfg.VAEModelConfig(**VAE_KW), jcfg.GANModelConfig(**GAN_KW)
    tv_cfg, tg_cfg = tcfg.VAEModelConfig(**VAE_KW), tcfg.GANModelConfig(**GAN_KW)
    vae_vars = jax_vae_variables(jv_cfg)
    g_params, g_stats = jax_generator_variables(jg_cfg)
    return dict(
        jv_cfg=jv_cfg, jg_cfg=jg_cfg, vae_vars=vae_vars, g_params=g_params, g_stats=g_stats,
        t_cfg=tcfg.GANConfig(model=tg_cfg, vae=tv_cfg, noise_range=NOISE_RANGE),
        vae_sd=convert.betavae_state_dict_from_jax(tv_cfg, vae_vars),
        g_sd=convert.generator_state_dict_from_jax(tg_cfg, g_params, g_stats),
    )


@pytest.fixture(scope="module")
def port_vae(weights):
    vae = BetaVAE(weights["t_cfg"].vae)
    vae.load_state_dict(weights["vae_sd"])
    return vae.eval()


def _np(t):
    return t.detach().numpy()


# ----------------------------------------------------------------- models


def test_vae_encode_matches_jax(weights, port_vae, rng):
    x = rng.randn(6, VAE_KW["rna_features"]).astype(np.float32)
    ref = JaxBetaVAE(weights["jv_cfg"]).apply(weights["vae_vars"], jnp.asarray(x), train=False,
                                              method=JaxBetaVAE.encode)
    got = port_vae.encode(torch.from_numpy(x))
    for name, r, g in zip(("z_mean", "z_logvar", "x_encoded"), ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)


def test_vae_decode_and_sample_match_jax(weights, port_vae, rng):
    z = rng.randn(5, VAE_KW["z_dim"]).astype(np.float32)
    direction = rng.randn(1, VAE_KW["z_dim"]).astype(np.float32)
    jvae = JaxBetaVAE(weights["jv_cfg"])
    ref = jvae.apply(weights["vae_vars"], jnp.asarray(z), train=False, method=JaxBetaVAE.decode)
    np.testing.assert_allclose(_np(port_vae.decode(torch.from_numpy(z))), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    ref_s = jvae.apply(weights["vae_vars"], jnp.asarray(z), jnp.asarray(direction), 0.5,
                       method=JaxBetaVAE.sample)
    got_s = port_vae.sample(torch.from_numpy(z), torch.from_numpy(direction), 0.5)
    np.testing.assert_allclose(_np(got_s), np.asarray(ref_s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("final_tanh", [True, False])
def test_generator_eval_matches_jax(weights, rng, final_tanh):
    z = rng.randn(3, GAN_KW["encoding_dims"]).astype(np.float32)
    gen = dataclasses.replace(make_generator(weights["jg_cfg"]), final_tanh=final_tanh)
    ref = gen.apply({"params": weights["g_params"], "batch_stats": weights["g_stats"]},
                    jnp.asarray(z), train=False)
    port = DCGANGenerator(weights["t_cfg"].model, final_tanh=final_tanh)
    port.load_state_dict(weights["g_sd"])
    got = _np(port.eval()(torch.from_numpy(z)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_folded_generator_matches_lax_apply(weights, rng):
    z = rng.randn(3, GAN_KW["encoding_dims"]).astype(np.float32)
    _, jfolded = fold_generator(weights["jg_cfg"], weights["g_params"], weights["g_stats"])
    ref = dcgan_lax_apply(weights["jg_cfg"], jfolded["params"], jnp.asarray(z))
    folded_cfg, folded_sd = tserving.fold_generator(weights["t_cfg"].model, weights["g_sd"])
    assert not folded_cfg.batchnorm
    port = DCGANGenerator(folded_cfg)
    port.load_state_dict(folded_sd)
    got = _np(port.eval()(torch.from_numpy(z)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("arch", ["sagan", "biggan"])
def test_later_archs_name_their_roadmap_item(arch):
    """The archs of ROADMAP A13 are ported: the registry builds them, and the
    DCGAN class refuses them."""
    from rnagan_tpu_torch.models.registry import make_generator

    cfg = tcfg.GANModelConfig(arch=arch, **GAN_KW)
    assert type(make_generator(cfg)).__name__.lower().startswith(arch)
    with pytest.raises(ValueError, match=arch):
        DCGANGenerator(cfg)


# ------------------------------------------------------------ whole slice


def _jax_slice(w, gene, u, *, uint8_output, z_pop=None):
    """encode_z_mean -> infusion -> make_serving_fn, the JAX package's path."""
    jvae = JaxBetaVAE(w["jv_cfg"])
    z = jinf.encode_z_mean(jvae, w["vae_vars"], jnp.asarray(gene))
    if z_pop is None:
        noise = jinf.standardize_batch(jnp.asarray(u) + z)
    else:
        var_u = (2.0 * NOISE_RANGE) ** 2 / 12.0
        noise = (jnp.asarray(u) + z - z_pop[0]) / jnp.sqrt(jnp.square(z_pop[1]) + var_u)
    with pltpu.force_tpu_interpret_mode():
        fn = make_serving_fn(w["jg_cfg"], w["g_params"], w["g_stats"], uint8_output=uint8_output)
        return np.asarray(fn(noise))


def _uniforms(n, seed=0):
    return np.array(jax.random.uniform(jax.random.key(seed), (n, GAN_KW["encoding_dims"]),
                                       jnp.float32, -NOISE_RANGE, NOISE_RANGE))


def _assert_uint8_close(got, ref, share):
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < share
    assert got.std() > 10  # tiles span the range: the comparison is not of constants


def test_slice_uint8_matches_jax(weights, rng):
    gene = rng.randn(6, VAE_KW["rna_features"]).astype(np.float32)
    u = _uniforms(6)
    ref = _jax_slice(weights, gene, u, uint8_output=True)
    synth = Synthesizer(weights["t_cfg"], weights["vae_sd"], weights["g_sd"], device="cpu")
    got = synth.synthesize(gene, u=u).numpy()
    assert got.shape == (6, 64, 64, 3)
    _assert_uint8_close(got, ref, 0.005)


def test_slice_float_matches_jax(weights, rng):
    gene = rng.randn(6, VAE_KW["rna_features"]).astype(np.float32)
    u = _uniforms(6, seed=1)
    ref = _jax_slice(weights, gene, u, uint8_output=False)
    synth = Synthesizer(weights["t_cfg"], weights["vae_sd"], weights["g_sd"], uint8_output=False,
                        device="cpu")
    got = synth.synthesize(gene, u=u).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_slice_single_patient_broadcast(weights, rng):
    """One (1, F) patient over n samples: the reference's per-batch
    standardization cancels its z, so the tiles follow the uniforms alone."""
    gene = rng.randn(1, VAE_KW["rna_features"]).astype(np.float32)
    u = _uniforms(5, seed=2)
    ref = _jax_slice(weights, gene, u, uint8_output=True)
    synth = Synthesizer(weights["t_cfg"], weights["vae_sd"], weights["g_sd"], device="cpu")
    got = synth.synthesize(gene, 5, u=u).numpy()
    assert got.shape == (5, 64, 64, 3)
    _assert_uint8_close(got, ref, 0.005)


def test_slice_population_mode(weights, port_vae, rng):
    rna = rng.randn(40, VAE_KW["rna_features"]).astype(np.float32)
    jpop = jinf.z_population_stats(JaxBetaVAE(weights["jv_cfg"]), weights["vae_vars"], rna,
                                   batch_size=16)
    tpop = tinf.z_population_stats(port_vae, rna, batch_size=16)
    for j, t in zip(jpop, tpop):
        np.testing.assert_allclose(_np(t), j, rtol=1e-5, atol=1e-5)

    gene = rna[:1]
    u = _uniforms(4, seed=3)
    ref = _jax_slice(weights, gene, u, uint8_output=True, z_pop=tuple(map(jnp.asarray, jpop)))
    synth = Synthesizer(weights["t_cfg"], weights["vae_sd"], weights["g_sd"], device="cpu")
    got = synth.synthesize(gene, 4, u=u, z_pop=tpop).numpy()
    _assert_uint8_close(got, ref, 0.005)
    # the noise itself, against the JAX function on the same key's uniforms
    z = port_vae.encode(torch.from_numpy(gene))[0]
    jz = jinf.encode_z_mean(JaxBetaVAE(weights["jv_cfg"]), weights["vae_vars"], jnp.asarray(gene))
    jnoise = jinf.infused_noise_population(jax.random.key(3), jz, *map(jnp.asarray, jpop), 4,
                                           NOISE_RANGE)
    tnoise = tinf.infused_noise_population(z, *tpop, 4, u=torch.from_numpy(u),
                                           noise_range=NOISE_RANGE)
    np.testing.assert_allclose(_np(tnoise), np.asarray(jnoise), atol=1e-5)


# ---------------------------------------------------------------- loaders


def test_vae_pt_loads_through_port_loader(weights, tmp_path):
    from rnagan_tpu.models.betavae import params_to_torch_state_dict

    sd = params_to_torch_state_dict(weights["jv_cfg"], weights["vae_vars"])
    path = tmp_path / "model_dict_best.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    loaded = convert.load_betavae_state_dict(str(path))
    assert loaded.keys() == weights["vae_sd"].keys()
    for k, v in weights["vae_sd"].items():
        assert torch.equal(loaded[k], v), k
    BetaVAE(weights["t_cfg"].vae).load_state_dict(loaded)  # strict


def test_torchgan_bundle_loads_through_port_loader(weights, tmp_path):
    import types

    import optax

    from rnagan_tpu.models.dcgan import make_discriminator
    from rnagan_tpu.models.dcgan_torch import export_torchgan_bundle

    cfg = jcfg.GANConfig(model=weights["jg_cfg"], vae=weights["jv_cfg"])
    d = make_discriminator(weights["jg_cfg"])
    dv = jax.jit(lambda k: d.init(k, jnp.zeros((2, 64, 64, 3)), train=False))(jax.random.key(0))
    adam = optax.adam(1e-4)
    state = types.SimpleNamespace(
        g_params=weights["g_params"], g_stats=weights["g_stats"],
        g_opt=adam.init(weights["g_params"]),
        d_params=dv["params"], d_stats=dv["batch_stats"], d_opt=adam.init(dv["params"]))
    path = tmp_path / "rna-gan.model"
    export_torchgan_bundle(str(path), cfg, state, epoch=3)
    loaded = convert.load_generator_state_dict(str(path))
    assert loaded.keys() == weights["g_sd"].keys()
    for k, v in weights["g_sd"].items():
        assert torch.equal(loaded[k], v), k
    DCGANGenerator(weights["t_cfg"].model).load_state_dict(loaded)  # strict
