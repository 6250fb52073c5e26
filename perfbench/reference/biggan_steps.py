"""The first ``wganvae`` training steps of the published BigGAN, in plain float32 ops.

:func:`gan_steps` is ``train_steps.gan_steps`` (RNA-GAN's ``wganvae`` step
with the per-sample gradient penalty, stage by stage, and optax's Adam) with
the nets of ``reference/biggan.py``, the batch's class ``labels`` going into
G and D at every stage (the penalty's D included), and the state of both
nets (BatchNorm statistics and each spectral norm's ``u``) threaded as
``train_steps`` threads the DCGAN's statistics: D's real pass, then its fake
pass; the penalty reads the latter and its own update is dropped; the G
stage starts from the D stage's. ``q``, ``half``, ``half_real`` as there;
``half`` also halves the labels, ``half_real`` keeps them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from perfbench.reference import biggan, draws, nets
from perfbench.reference.train_steps import STAGES, Adam


def gan_steps(g_sd, d_sd, vae_sd, batches: Sequence[Dict[str, torch.Tensor]], seeds: Sequence[Sequence[int]],
              m: dict, vae_m: dict, hp: dict, q=nets.identity, half: bool = False, half_real: bool = False) -> dict:
    """``len(batches)`` steps from the state dicts ``g_sd``, ``d_sd`` (copied).

    ``batches[i]``: ``image`` (N, H, W, C) float32 in [-1, 1], ``rna_data``
    (N, F) and ``labels`` (N,); ``seeds[i]``: the step's stage seeds (d, gp,
    g, eps). Returns ``train_steps.gan_steps``' dict; ``state`` and
    ``stats_after`` hold the names of ``biggan.state_names``."""
    params, state = biggan.specs(m)
    sd = {"G": g_sd, "D": d_sd}
    pg = {n: g_sd[n].detach().clone().requires_grad_(True) for net, n, _, _ in params if net == "G"}
    pd = {n: d_sd[n].detach().clone().requires_grad_(True) for net, n, _, _ in params if net == "D"}
    kept = {"G": {}, "D": {}}
    for net, prefix, kind, _ in state:
        for leaf in (("running_mean", "running_var") if kind == "bn" else ("sn_u",)):
            kept[net][prefix + leaf] = sd[net][prefix + leaf].clone()
    sg, sdd = kept["G"], kept["D"]
    v_stats = nets.stats_list(vae_sd, [p for p, _ in nets.vae_specs(vae_m)[1]])
    opt_g = Adam(pg, hp["g_lr"], hp["b1"], hp["b2"])
    opt_d = Adam(pd, hp["d_lr"], hp["b1"], hp["b2"])
    r = hp["noise_range"]
    losses, first, stats_after = [], None, []

    def named(sg_, sd_):
        return {**{"G." + k: v for k, v in sg_.items()}, **{"D." + k: v for k, v in sd_.items()}}

    for batch, seed in zip(batches, seeds):
        real = batch["image"].float().permute(0, 3, 1, 2).contiguous()
        labels = batch["labels"].long()
        n = real.shape[0]
        z_mean = nets.z_mean_eval(vae_sd, v_stats, batch["rna_data"].float(), vae_m, q)
        keep = slice(0, n // 2 if half else n)
        noise_d = draws.infused_noise(z_mean, seed[STAGES["d"]], r)
        noise_g = draws.infused_noise(z_mean, seed[STAGES["g"]], r)
        eps = draws.uniform(seed[STAGES["eps"]], (n, 1, 1, 1), real.device)
        real, labels, noise_d, noise_g, eps = real[keep], labels[keep], noise_d[keep], noise_g[keep], eps[keep]
        if half_real:
            real = torch.cat([real[:len(real) // 2]] * 2)
        # D stage
        with torch.no_grad():
            fake, sg1 = biggan.generator(pg, sg, noise_d, labels, True, m, q)
        dx, s1 = biggan.discriminator(pd, sdd, real, labels, True, m, q)
        dgz, s2 = biggan.discriminator(pd, s1, fake, labels, True, m, q)
        d_loss = (dgz - dx).mean()
        x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
        scores = biggan.discriminator(pd, s2, x_hat, labels, True, m, q)[0]
        (gx,) = torch.autograd.grad(scores.sum(), x_hat, create_graph=True)
        norms = torch.sqrt((gx * gx).reshape(gx.shape[0], -1).sum(dim=1) + 1e-12)
        gp = ((norms - 1.0) ** 2).mean()
        grads_d = dict(zip(pd, torch.autograd.grad(d_loss + hp["gp_lambda"] * gp, list(pd.values()))))
        opt_d.step(pd, grads_d)
        sg, sdd = sg1, s2
        # G stage
        fake, sg2 = biggan.generator(pg, sg, noise_g, labels, True, m, q)
        dgz_g, s3 = biggan.discriminator(pd, sdd, fake, labels, True, m, q)
        g_loss = -dgz_g.mean()
        grads_g = dict(zip(pg, torch.autograd.grad(g_loss, list(pg.values()))))
        opt_g.step(pg, grads_g)
        sg, sdd = sg2, s3
        scale = float(torch.cat([dx, dgz]).detach().abs().mean())
        losses.append({"d_loss": float(d_loss.detach()), "gp": float(gp.detach()), "g_loss": float(g_loss.detach()),
                       "dx": float(dx.detach().mean()), "dgz": float(dgz.detach().mean()), "scale": scale})
        stats_after.append({k: v.detach() for k, v in named(sg, sdd).items()})
        if first is None:
            first = {**{"G." + k: v.detach() for k, v in grads_g.items()},
                     **{"D." + k: v.detach() for k, v in grads_d.items()}}
    state_out = {**{"G." + k: v.detach() for k, v in pg.items()}, **{"D." + k: v.detach() for k, v in pd.items()},
                 **stats_after[-1]}
    return {"losses": losses, "first_grads": first, "state": state_out, "stats_after": stats_after}
