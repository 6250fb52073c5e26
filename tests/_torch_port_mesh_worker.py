"""Rank-side functions of the mesh tests (``tests/test_torch_port_mesh*.py``).

Each is called as ``fn(rank, world_size, *args)`` in the processes of a gloo
world that ``rnagan_tpu_torch.parallel.launch.spawn`` starts (one torch
thread each), or with ``(0, 1, ...)`` in the test process itself as the
one-rank world (no process group: the one-device mesh). Each builds its
trainer, takes this rank's rows of the global batch and returns CPU
tensors. Nothing here imports JAX: the children import this module only.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist

from rnagan_tpu_torch.core.config import MeshConfig
from rnagan_tpu_torch.kernels.infusion import infused_noise
from rnagan_tpu_torch.models.batchnorm import batch_norm
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import init_distributed, local_rows, make_mesh, shard_batch


def _world():
    return dist.group.WORLD if dist.is_initialized() else None


def k1_group(rank, world, z, u, seed, counts, noise_range):
    """This rank's rows (``counts`` rows a rank, ragged) of the global
    batch's infused noise, from given uniforms and from the seed."""
    row0 = sum(counts[:rank])
    rows = slice(row0, row0 + counts[rank])
    zt = torch.from_numpy(z[rows]).contiguous()
    kw = dict(noise_range=noise_range, group=_world(), row0=row0)
    return {"u": infused_noise(zt, counts[rank], u=torch.from_numpy(u[rows]).contiguous(), **kw),
            "seed": infused_noise(zt, counts[rank], seed=seed, **kw)}


def bn_world(rank, world, x, w, scale, bias, mean, var):
    """Train-mode BatchNorm on this rank's rows: the output, the new
    statistics, the input gradient of ``sum(y * w)`` and, summed over the
    ranks, its scale and bias gradients and the scale gradient of the double
    backward ``sum(grad_x ** 2)`` (the input gradient does not depend on the
    bias)."""
    mesh = make_mesh(MeshConfig(), "cpu")
    rows = local_rows(len(x), mesh)
    xl = torch.from_numpy(x[rows]).requires_grad_(True)
    s = torch.from_numpy(scale).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    with collectives.active(mesh):
        y, m, v = batch_norm(xl, s, b, torch.from_numpy(mean), torch.from_numpy(var), train=True)
        gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(w[rows])).sum(), (xl, s, b), create_graph=True)
        (g2,) = torch.autograd.grad((gx * gx).sum(), s)
    gs, gb, g2 = collectives.all_reduce_grads([gs.detach(), gb.detach(), g2], mesh.data_group)
    return {"y": y, "mean": m, "var": v, "gx": gx, "gscale": gs, "gbias": gb, "g2scale": g2}


def gan_world(rank, world, cases, vae_sd, batches, n_steps):
    """``GANTrainer`` steps for each case ``(name, GANConfig)`` from its seeded
    init on ``batches[name]``, drawing its own noise: the global metrics of
    every step and the final parameters and state pairs (BatchNorm
    statistics, spectral-norm ``(u, sigma)``)."""
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    out = {}
    for name, cfg in cases:
        tr = GANTrainer(cfg, vae_sd if cfg.loss_type == "wganvae" else None, device="cpu")
        st = tr.init_state()
        metrics = []
        for k in range(n_steps):
            st, met = tr.train_step(st, shard_batch(batches[name][k], tr.mesh))
            metrics.append({key: float(v) for key, v in met.items()})
        out[name] = {"metrics": metrics, "params": dict(st.generator.named_parameters())
                     | {"D." + n: p for n, p in st.discriminator.named_parameters()},
                     "stats": [t for pair in st.g_stats + st.d_stats for t in pair]}
    return out


def gan_given(rank, world, cfg, vae_sd, state, batch, draws):
    """One ``GANTrainer`` step from ``state`` on this rank's rows of ``batch``
    with the global batch's ``draws``: metrics, parameters, statistics and
    Adam moments."""
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    tr = GANTrainer(cfg, vae_sd, device="cpu")
    st = copy.deepcopy(state)
    st, met = tr.train_step(st, shard_batch(batch, tr.mesh), draws=draws)
    return {"metrics": {k: float(v) for k, v in met.items()}, "g": list(st.generator.parameters()),
            "d": list(st.discriminator.parameters()), "g_stats": st.g_stats, "d_stats": st.d_stats,
            "g_mu": st.g_opt.mu, "g_nu": st.g_opt.nu, "d_mu": st.d_opt.mu, "d_nu": st.d_opt.nu}


def vae_world(rank, world, cfg, train, val, save_dir):
    """``VAETrainer.fit`` on the global data (every rank passes all of it):
    its history, the shape of this rank's first Linear weight and the
    gathered state_dict of the best state."""
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    tr = VAETrainer(cfg, device="cpu")
    state = tr.init_state()
    first = tuple(state.model.encoder.encoder[1][0].weight.shape)
    state, results = tr.fit(train, val, save_dir=save_dir, state=state)
    return {"history": results["history"], "first_linear": first, "state_dict": tr.full_state_dict(state)}


def _resnet_out(st, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "state_dict": st.model.state_dict(),
            "mu": st.opt.mu, "nu": st.opt.nu, "count": st.opt.count}


def ml_step(rank, world, cfg, model, state, images, labels, mask, draws):
    """One classifier step from ``state`` on this rank's rows."""
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer

    tr = TileClassifierTrainer(cfg, model=model, device="cpu")
    st = copy.deepcopy(state)
    x, y, m = shard_batch((images, labels, mask), tr.mesh)
    st, met = tr.train_step(st, x, y, m, draws=draws)
    return _resnet_out(st, met)


def ssl_step(rank, world, cfg, backbone, state, images, draws):
    """One SimCLR step from ``state`` on this rank's rows."""
    from rnagan_tpu_torch.train.ssl_trainer import SimCLRTrainer

    tr = SimCLRTrainer(cfg, backbone=backbone, device="cpu")
    st = copy.deepcopy(state)
    st, met = tr.train_step(st, shard_batch(images, tr.mesh), draws=draws)
    return _resnet_out(st, met)


def nt_xent_world(rank, world, z, temperature):
    """NT-Xent of the global [A; B] projections ``z`` from this rank's rows
    (its A rows, then its B rows): the global loss and accuracy, and the
    gradient of the loss at this rank's rows."""
    from rnagan_tpu_torch.train.ssl_trainer import nt_xent_loss

    mesh = make_mesh(MeshConfig(), "cpu")
    n = len(z) // 2
    rows = local_rows(n, mesh)
    mine = torch.from_numpy(np.concatenate([z[:n][rows], z[n:][rows]])).requires_grad_(True)
    loss, acc = nt_xent_loss(mine, temperature, mesh.data_group)
    (grad,) = torch.autograd.grad(loss, mine)
    return {"metrics": collectives.reduce_metrics({"loss": loss.detach(), "acc": acc}, mesh.data_group),
            "grad": grad}


def fusion_step(rank, world, cfg, backbone, state, bags, rna, labels, mask, keep):
    """One fusion step from ``state`` on this rank's bags."""
    from rnagan_tpu_torch.train.fusion_trainer import FusionTrainer

    tr = FusionTrainer(cfg, backbone=backbone, device="cpu")
    st = copy.deepcopy(state)
    b, r, y, m = shard_batch((bags, rna, labels, mask), tr.mesh)
    st, met = tr.train_step(st, b, r, y, m, draws={"keep": keep})
    return _resnet_out(st, met)


def warm_adam(state, seed=0):
    """Adam moments as at step 5 (``nu`` far above ``(1-b2) g^2``), drawn from
    a CPU generator of ``seed``. From zero moments a first step moves every
    parameter by sign(g) * lr, so a gradient that is 0 up to rounding (the
    critic's last bias under the wgan loss, whose real and fake terms cancel)
    moves by the rate on one side and not on the other."""
    gen = torch.Generator().manual_seed(seed)
    for opt in (state.g_opt, state.d_opt):
        for mu, nu in zip(opt.mu, opt.nu):
            mu.copy_(torch.randn(mu.shape, generator=gen) * 1e-3)
            nu.copy_((torch.rand(nu.shape, generator=gen) + 0.5) * 1e-2)
        opt.count = 5
    state.step = 5
    return state


def multihost_child(pid, port, cfg, local_batch, results):
    """A process that joins a 2-process world through ``init_distributed``
    with an explicit coordinator and takes one GAN step, from
    :func:`warm_adam` moments, on the half of the global batch it holds
    alone (``shard_batch(local=True)``)."""
    try:
        torch.set_num_threads(1)
        init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid, backend="gloo")
        from rnagan_tpu_torch.train.gan_trainer import GANTrainer

        tr = GANTrainer(cfg, device="cpu")
        st = warm_adam(tr.init_state())
        st, met = tr.train_step(st, shard_batch(local_batch, tr.mesh, local=True))
        results.put((pid, {k: float(v) for k, v in met.items()}, tr.mesh.world))
        dist.destroy_process_group()
    except Exception as e:  # the test reports it
        results.put((pid, repr(e), -1))
