"""The port's data-parallel GAN step: a world of 2 gloo ranks on the CPU
against one rank in the port, and against the JAX package's trainer on a
2-device data mesh.

The JAX package's sharding claim (``tests/test_sharding_equivalence.py:1-5``)
held in the port: a step over 2 ranks gives the numbers of the one-rank step
on the same global batch (BatchNorm, K1's noise standardization, the losses,
the gradient penalty and the updates are global-batch operations, reduced
over the data group), up to the order of reductions. The cases and
tolerances are that test's (``:48``, ``:54-63``): metrics rtol 5e-3, atol
2e-5 growing tenfold a step, G's first ConvTranspose kernel within 5e-4
after three steps. The replicas stay bit-equal. Against the JAX mesh, one
step from a step-5 state with the JAX step's own draws, at the one-step
tolerances of ``tests/test_torch_port_train.py``.
"""

import jax
import numpy as np
import torch
from _torch_port_mesh_worker import gan_given, gan_world
from test_torch_port_train import (F32, N, VAE_KW, _cfgs, _close_list, _close_stats, _draws,
                                   _jax_state, _port_state, _stats, vae)  # noqa: F401 (vae: a fixture)

from rnagan_tpu.core.config import MeshConfig as JaxMeshConfig
from rnagan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rnagan_tpu.parallel.mesh import replicated as jax_replicated
from rnagan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.models.dcgan import num_repeats
from rnagan_tpu_torch.parallel.launch import spawn
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

VAE_SMALL = VAEModelConfig(rna_features=20, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,))
MODEL32 = GANModelConfig(encoding_dims=16, out_size=32, step_channels=8, compute_dtype="float32")
#: the JAX tests' SAGAN16 (tests/test_attention_gans.py): spectral norm in D and G
SAGAN16 = GANModelConfig(arch="sagan", encoding_dims=16, out_size=16, step_channels=4, attn_size=8,
                         compute_dtype="float32")
CASES = [(name, GANConfig(model=model, loss_type=loss, batch_size=16, vae=VAE_SMALL, compat_reference_gp=compat,
                          seed=7))
         for name, model, loss, compat in (("wganvae", MODEL32, "wganvae", False),
                                           ("wganvae_compat", MODEL32, "wganvae", True),
                                           ("lsgan", MODEL32, "lsgan", False), ("sagan", SAGAN16, "wganvae", False))]


def test_train_steps_identical_across_world_sizes():
    """Three steps of each case from the seeded init, every draw made by the
    trainer (K1's Philox rows, the GP's eps): world 2 against world 1 at the
    JAX sharding test's tolerances, and the two replicas bit-equal, their
    spectral-norm state (SAGAN's power iteration) included."""
    vae_sd = BetaVAE(VAE_SMALL, seed=3).state_dict()
    rng = np.random.RandomState(0)
    batches = {name: [{"image": rng.rand(16, cfg.model.out_size, cfg.model.out_size, 3).astype(F32) * 2 - 1,
                       "rna_data": rng.randn(16, 20).astype(F32)} for _ in range(3)] for name, cfg in CASES}
    ref = gan_world(0, 1, CASES, vae_sd, batches, 3)
    outs = spawn(gan_world, 2, CASES, vae_sd, batches, 3, backend="gloo", threads=1, timeout=300)
    for name, _ in CASES:
        for step, (a, b) in enumerate(zip(ref[name]["metrics"], outs[0][name]["metrics"])):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=5e-3, atol=2e-5 * 10**step,
                                           err_msg=f"{name}: metric {k} at step {step}")
        first = next(iter(ref[name]["params"]))  # G's first kernel
        np.testing.assert_allclose(outs[0][name]["params"][first].numpy(),
                                   ref[name]["params"][first].detach().numpy(), atol=5e-4)
        assert outs[0][name]["metrics"] == outs[1][name]["metrics"], name
        for k, p in outs[0][name]["params"].items():
            assert torch.equal(p, outs[1][name]["params"][k]), f"{name}: replicas differ at {k}"
        for a, b in zip(outs[0][name]["stats"], outs[1][name]["stats"]):
            assert torch.equal(a, b), f"{name}: replicas' state pairs differ"


def test_world_2_step_matches_jax_two_device_mesh(vae):
    """One wganvae step (fused per-sample GP) from a step-5 state: the port
    over 2 ranks against the JAX trainer over a 2-device data mesh, both on
    the global batch of 4 with the JAX step's draws; metrics, parameters,
    BatchNorm statistics and Adam moments at the one-step tolerances of
    ``tests/test_torch_port_train.py``."""
    jc, tc = _cfgs({}, {})
    vae_vars, vae_sd = vae
    mesh2 = jax_make_mesh(JaxMeshConfig(data=2, model=1), devices=jax.devices()[:2])
    jtr = JaxGANTrainer(jc, vae_variables=vae_vars, mesh=mesh2)
    js = jax.device_put(_jax_state(jtr, jc), jax_replicated(mesh2))
    state = _port_state(GANTrainer(tc, vae_sd, device="cpu"), tc, _jax_state(jtr, jc))
    rng = np.random.RandomState(1)
    img = (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8)
    batch = {"image": img.astype(F32) / 127.5 - 1.0, "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
    key = jax.random.key(100)
    js, jmet = jtr._train_step(js, {**jax_shard_batch(batch, mesh2), "rng": key}, jtr.vae_variables)
    outs = spawn(gan_given, 2, tc, vae_sd, state, batch, _draws(key, jc), backend="gloo", threads=1,
                 timeout=300)
    got = outs[0]
    assert set(got["metrics"]) == set(jmet)
    for name in jmet:
        np.testing.assert_allclose(got["metrics"][name], float(jmet[name]), rtol=1e-4, atol=1e-7, err_msg=name)
    m = tc.model
    r = num_repeats(m.out_size)
    for net, key_, jparams, jstats, jopt, n_bn in (("generator", "g", js.g_params, js.g_stats, js.g_opt, r + 1),
                                                   ("discriminator", "d", js.d_params, js.d_stats, js.d_opt, r)):
        _close_list(got[key_], convert.param_list_from_jax(m, net, jparams), rtol=1e-6, atol=1e-7)
        _close_stats(got[f"{key_}_stats"], _stats(jstats, n_bn))
        mus, nus = convert.adam_moments_from_jax(m, net, jopt[0].mu, jopt[0].nu)
        _close_list(got[f"{key_}_mu"], mus, rtol=1e-4, atol=1e-7, scaled=1e-5)
        _close_list(got[f"{key_}_nu"], nus, rtol=1e-4, atol=1e-9, scaled=1e-5)
        for a, b in zip(got[key_], outs[1][key_]):
            assert torch.equal(a, b), f"{net}: replicas differ"
