"""The first training steps of the two configurations, in plain float32 ops.

:func:`gan_steps` is RNA-GAN's ``wganvae`` step (paper's ``src/wgan_loss.py``
with the per-sample gradient penalty), stage by stage:

* the frozen β-VAE encodes the batch's expression rows (eval mode);
* D stage: G (train mode) makes fakes from the infused noise of the stage's
  seed; D scores the real tiles, then the fakes, each pass updating D's
  running statistics; the critic loss ``mean(D(fake) - D(real))`` plus
  ``gp_lambda`` times the mean of ``(||grad_x D(x_hat)|| - 1)^2`` at
  ``x_hat = eps * real + (1 - eps) * fake`` (D in train mode on the
  statistics after the fake pass, its own update dropped); one Adam step of D;
* G stage: new fakes from the G stage's noise, D (updated weights) scores
  them, ``-mean(D(fake))``, one Adam step of G.

:func:`vae_steps` is the β-VAE's step (``src/betaVAE.py``): rows drawn with
replacement from the resident matrix, input dropout, encode, reparametrize,
decode, ``mse + beta * KL``, one Adam step at the warmup-and-cosine rate of
the step's count.

Adam is optax's (``mu/c1 / (sqrt(nu/c2) + eps)``, bias corrections in
float32). Each function returns every step's losses, the first step's
gradients as the optimizer got them (per leaf) and the state after the last
step; :func:`gan_steps` also the running statistics after each step. ``q``
rounds the products' operands (the lower-precision controls); ``half``
leaves out the second half of each batch, the mean taken over the rest, and
``half_real`` the second half of the GAN's real tiles alone, the first half
read twice in their place (planted faults).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import draws, nets

STAGES = {"d": 0, "gp": 1, "g": 2, "eps": 3}


def bias_corrections(t: int, b1: float, b2: float):
    t32, one = np.float32(t), np.float32(1.0)
    return float(one - np.float32(b1) ** t32), float(one - np.float32(b2) ** t32)


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr=None) -> None:
        self.count += 1
        c1, c2 = bias_corrections(self.count, self.b1, self.b2)
        lr = self.lr if lr is None else lr
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.mu[k] * self.b1 + g * (1.0 - self.b1)
            self.nu[k] = self.nu[k] * self.b2 + (g * (1.0 - self.b2)) * g
            p.sub_((self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps) * lr)


def _leaves(params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return list(params.values())


def _named_stats(sg, sd, stat_prefixes) -> Dict[str, torch.Tensor]:
    """The nets' running statistics by their state names (``G.model.0.1.running_mean``, ...)."""
    out = {}
    for net, stats in (("G", sg), ("D", sd)):
        for (mean, var), prefix in zip(stats, [p for n_, p, _ in stat_prefixes if n_ == net], strict=True):
            out[f"{net}.{prefix}running_mean"], out[f"{net}.{prefix}running_var"] = mean, var
    return out


def gan_steps(g_sd, d_sd, vae_sd, batches: Sequence[Dict[str, torch.Tensor]], seeds: Sequence[Sequence[int]],
              m: dict, vae_m: dict, hp: dict, q=nets.identity, half: bool = False, half_real: bool = False) -> dict:
    """``len(batches)`` steps from the state dicts ``g_sd``, ``d_sd`` (copied).

    ``batches[i]``: ``image`` (N, H, W, C) float32 in [-1, 1] and ``rna_data``
    (N, F); ``seeds[i]``: the step's stage seeds (d, gp, g, eps)."""
    g_specs, d_specs = [], []
    for net, name, _, _ in nets.dcgan_specs(m)[0]:
        (g_specs if net == "G" else d_specs).append(name)
    stat_prefixes = nets.dcgan_specs(m)[1]
    pg = {k: g_sd[k].detach().clone().requires_grad_(True) for k in g_specs}
    pd = {k: d_sd[k].detach().clone().requires_grad_(True) for k in d_specs}
    sg = [(g_sd[p + "running_mean"].clone(), g_sd[p + "running_var"].clone()) for net, p, _ in stat_prefixes if net == "G"]
    sd = [(d_sd[p + "running_mean"].clone(), d_sd[p + "running_var"].clone()) for net, p, _ in stat_prefixes if net == "D"]
    v_stats = nets.stats_list(vae_sd, [p for p, _ in nets.vae_specs(vae_m)[1]])
    opt_g = Adam(pg, hp["g_lr"], hp["b1"], hp["b2"])
    opt_d = Adam(pd, hp["d_lr"], hp["b1"], hp["b2"])
    r = hp["noise_range"]
    losses, first, stats_after = [], None, []
    for batch, seed in zip(batches, seeds):
        real = batch["image"].float().permute(0, 3, 1, 2).contiguous()
        rna = batch["rna_data"].float()
        n = real.shape[0]
        z_mean = nets.z_mean_eval(vae_sd, v_stats, rna, vae_m, q)
        keep = slice(0, n // 2 if half else n)
        noise_d = draws.infused_noise(z_mean, seed[STAGES["d"]], r)
        noise_g = draws.infused_noise(z_mean, seed[STAGES["g"]], r)
        eps = draws.uniform(seed[STAGES["eps"]], (n, 1, 1, 1), real.device)
        real, noise_d, noise_g, eps = real[keep], noise_d[keep], noise_g[keep], eps[keep]
        if half_real:
            real = torch.cat([real[:len(real) // 2]] * 2)
        # D stage
        with torch.no_grad():
            fake, sg1 = nets.generator(pg, sg, noise_d, True, m, q)
            fake = torch.tanh(fake)
        dx, s1 = nets.discriminator(pd, sd, real, True, m, q)
        dgz, s2 = nets.discriminator(pd, s1, fake, True, m, q)
        d_loss = (dgz - dx).mean()
        x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(nets.discriminator(pd, s2, x_hat, True, m, q)[0].sum(), x_hat, create_graph=True)
        norms = torch.sqrt((gx * gx).reshape(gx.shape[0], -1).sum(dim=1) + 1e-12)
        gp = ((norms - 1.0) ** 2).mean()
        grads_d = dict(zip(pd, torch.autograd.grad(d_loss + hp["gp_lambda"] * gp, _leaves(pd))))
        opt_d.step(pd, grads_d)
        sg, sd = sg1, s2
        # G stage
        fake, sg2 = nets.generator(pg, sg, noise_g, True, m, q)
        dgz_g, s3 = nets.discriminator(pd, sd, torch.tanh(fake), True, m, q)
        g_loss = -dgz_g.mean()
        grads_g = dict(zip(pg, torch.autograd.grad(g_loss, _leaves(pg))))
        opt_g.step(pg, grads_g)
        sg, sd = sg2, s3
        scale = float(torch.cat([dx, dgz]).detach().abs().mean())
        losses.append({"d_loss": float(d_loss.detach()), "gp": float(gp.detach()), "g_loss": float(g_loss.detach()),
                       "dx": float(dx.detach().mean()), "dgz": float(dgz.detach().mean()), "scale": scale})
        stats_after.append(_named_stats(sg, sd, stat_prefixes))
        if first is None:
            first = {**{"G." + k: v.detach() for k, v in grads_g.items()},
                     **{"D." + k: v.detach() for k, v in grads_d.items()}}
    state = {**{"G." + k: v.detach() for k, v in pg.items()}, **{"D." + k: v.detach() for k, v in pd.items()},
             **stats_after[-1]}
    return {"losses": losses, "first_grads": first, "state": state, "stats_after": stats_after}


def warmup_cosine(base_lr: float, warmup: int, cosine: int, step: int) -> float:
    """The β-VAE's per-batch rate: linear warmup from 0, then the cosine closed form (float32)."""
    f = np.float32
    s = f(step)
    if s < f(warmup):
        return float(f(base_lr) * s / f(max(1, warmup)))
    t = s - f(warmup)
    return float(f(base_lr) * f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / f(cosine))))


def vae_steps(vae_sd, data: torch.Tensor, seeds: Sequence[Sequence[int]], batch: int, m: dict, hp: dict,
              q=nets.identity, half: bool = False) -> dict:
    """``len(seeds)`` steps from ``vae_sd`` (copied) on rows of ``data`` drawn
    by each step's seeds (keep mask, eps, rows)."""
    specs, stat_specs = nets.vae_specs(m)
    p = {name: vae_sd[name].detach().clone().requires_grad_(True) for name, _, _, _ in specs}
    stats = [(vae_sd[pre + "running_mean"].clone(), vae_sd[pre + "running_var"].clone()) for pre, _ in stat_specs]
    opt = Adam(p, hp["lr"], 0.9, 0.999)
    losses, first = [], None
    k0 = len(m["encoder_dims"])
    for i, seed in enumerate(seeds):
        rows = draws.randint(seed[2], len(data), (batch,), data.device)
        x = data.index_select(0, rows)
        keep = draws.uniform4(seed[0], (batch, m["rna_features"]), data.device) < 1.0 - m["dropout_rate"]
        eps = draws.normal(seed[1], (batch, m["z_dim"]), data.device)
        if half:
            x, keep, eps = x[:batch // 2], keep[:batch // 2], eps[:batch // 2]
        z_mean, z_logvar, s_enc = nets.vae_encode(p, stats, x, True, m, keep, q)
        z = z_mean + eps * torch.exp(0.5 * z_logvar)
        out, s_dec = nets.vae_decode(p, stats, z, True, m, q)
        recons = torch.mean(torch.square(out - x), dim=1).sum() / len(x)
        kl = (-0.5 * torch.sum(1.0 + z_logvar - torch.square(z_mean) - torch.exp(z_logvar), dim=1)).sum() / len(x)
        total = recons + hp["beta"] * kl
        grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        opt.step(p, grads, lr=warmup_cosine(hp["lr"], hp["warmup_steps"], hp["cosine_steps"], i))
        stats = s_enc + s_dec
        assert len(stats) == k0 + len(m["decoder_dims"])
        losses.append({"total_loss": float(total.detach()), "scale": abs(float(total.detach()))})
        if first is None:
            first = {k: v.detach() for k, v in grads.items()}
    state = {k: v.detach() for k, v in p.items()}
    for (mean, var), (pre, _) in zip(stats, stat_specs):
        state[pre + "running_mean"], state[pre + "running_var"] = mean, var
    return {"losses": losses, "first_grads": first, "state": state}
