"""The work counts against ``torch.utils.flop_counter.FlopCounterMode`` over the
frozen references' steps at small widths."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core.weights import dcgan_weights, vae_weights
from perfbench.counts import work
from perfbench.reference import nets, train_steps

M = dict(encoding_dims=16, out_size=32, out_channels=3, step_channels=4, leaky_slope=0.2)
VM = dict(rna_features=40, z_dim=16, encoder_dims=(24, 20, 16), decoder_dims=(20, 24), dropout_rate=0.5,
          leaky_slope=0.01, beta=5e-4)
HP = dict(noise_range=0.3, gp_lambda=10.0, g_lr=1e-4, d_lr=4e-4, b1=0.5, b2=0.999)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_gan_step_counts_what_the_reference_step_requires():
    w, v = dcgan_weights(M, 1, "cpu"), vae_weights(VM, 2, "cpu")
    b = 4
    batches = [{"image": torch.rand(b, 32, 32, 3) * 2 - 1, "rna_data": torch.randn(b, 40)}]
    ran = counted(lambda: train_steps.gan_steps(w["G"], w["D"], v, batches, [[1, 2, 3, 4]], M, VM, HP))
    c = work.gan_step_flops(M, VM, b)
    # autograd also runs the score layer's backward three times in the penalty's
    # double backward, where its incoming gradient is a constant: work the step does not need
    assert ran - (c["bf16"] + c["fp32"]) == 3 * 2 * b * work.discriminator_macs(M)[-1]


def test_vae_step_and_synthesis_counts_equal_the_counter():
    v = vae_weights(VM, 2, "cpu")
    data = torch.randn(50, 40)
    hp = dict(lr=5e-5, warmup_steps=1000, cosine_steps=500, beta=5e-4)
    assert counted(lambda: train_steps.vae_steps(v, data, [[1, 2, 3]], 8, VM, hp)) == work.vae_step_flops(VM, 8)["fp32"]
    w = dcgan_weights(M, 1, "cpu")
    stats = nets.stats_list(w["G"], [f"model.{i}.1." for i in range(3)])
    v_stats = nets.stats_list(v, [p for p, _ in nets.vae_specs(VM)[1]])
    c = work.synth_request_flops(M, VM, 6)
    assert counted(lambda: nets.generator(w["G"], stats, torch.randn(6, 16), False, M)) == c["bf16"]
    assert counted(lambda: nets.z_mean_eval(v, v_stats, torch.randn(6, 40), VM)) == c["fp32"]


def test_parameter_counts_match_the_published_widths():
    m = dict(encoding_dims=2048, out_size=256, out_channels=3, step_channels=64)
    vm = dict(rna_features=19198, z_dim=2048, encoder_dims=(6000, 4000, 2048), decoder_dims=(4000, 6000))
    assert work.dcgan_params(m) == 156_554_948
    assert work.vae_params(vm) == 303_238_046
