"""Quality-validation run on the PyTorch port: FID-vs-epoch for RNA-GAN
(wganvae) against the plain GAN (wgan).

The counterpart of ``tools/quality_run.py``, on ``rnagan_tpu_torch`` (it
imports the port, numpy and the standard library only). The reference's
headline claim is an epoch budget to quality: RNA-GAN reaches visual quality
in 24 epochs on brain where the plain GAN needs 39 (reference
``README.md:62-81``). GTEx tiles and expression are not at hand, so the run
uses the procedural corpus (``rnagan_tpu_torch/data/synthetic.py``), whose
slide latents drive both tile morphology and a 19,198-gene expression
profile: RNA infusion has the information channel the reference exploits.

Steps, in the JAX tool's order:

1. the corpus on the device (latents, gene map, expression);
2. host log + standardize of the expression (``data/rna.py``);
3. the beta-VAE pre-trained on it through ``VAETrainer`` (best on validation
   kept; wganvae only);
4. ``GANTrainer.fit``, one call an epoch, on batches rendered on the device
   (``SyntheticCorpus.batches``), with the FID probe as its ``eval_fn`` and
   ``keep_best_metric="fid"``;
5. the FID probe: held-out rendered tiles against ``GANTrainer.sample``'s
   fakes, InceptionV3 features (seeded random init, or trained weights from
   ``INCEPTION_WEIGHTS``) whitened by the real set's per-dimension
   statistics, the split-half real-vs-real FID kept as the floor;
6. grids (``real.png`` once, fakes every ``--save_every`` epochs) and a JSON
   of ``meta`` + ``history`` + ``best`` with the JAX tool's keys.

``--device`` replaces ``--platform``. ``--compile_only`` and
``--steps_per_dispatch`` exist in the JAX tool only for its remote TPU
(ahead-of-time compilation, a per-execution deadline) and are dropped. The
random streams are the port's own, so a run is not the JAX run's bits.

Usage:
  python tools/quality_run_torch.py --loss_type wganvae --epochs 24
  python tools/quality_run_torch.py --loss_type wgan    --epochs 39
  python tools/quality_run_torch.py --smoke --device cpu   # tiny shapes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def build_parser():
    p = argparse.ArgumentParser(description="FID-vs-epoch quality run on the procedural corpus")
    p.add_argument("--loss_type", default="wganvae", choices=["wganvae", "wgan"])
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--slides", type=int, default=200)
    p.add_argument("--tiles_per_slide", type=int, default=600)
    p.add_argument("--genes", type=int, default=19198)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=None,
                   help="GAN seed (init + per-step noise/data order); the corpus and VAE "
                        "pre-train stay fixed, so runs of several seeds vary only the training")
    p.add_argument("--vae_epochs", type=int, default=200)
    p.add_argument("--fid_n", type=int, default=512)
    p.add_argument("--fid_batch", type=int, default=64)
    p.add_argument("--fid_every", type=int, default=1)
    p.add_argument("--save_every", type=int, default=5)
    p.add_argument("--no_ckpt", action="store_true", help="skip the .model checkpoints (grids are still written)")
    p.add_argument("--workdir", default="runs/quality")
    p.add_argument("--out", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--tag", default=None, help="run name (output files suffix)")
    p.add_argument("--compat_gp", action="store_true",
                   help="reference dynamics: separate GP Adam step, scalar eps, global norm")
    p.add_argument("--no_clip", action="store_true", help="disable the wgan +-0.01 weight clip")
    p.add_argument("--n_critic", type=int, default=1, help="critic steps per G update")
    p.add_argument("--g_lr", type=float, default=None)
    p.add_argument("--d_lr", type=float, default=None)
    p.add_argument("--arch", default="dcgan", choices=["dcgan", "dcgan_up", "sagan", "biggan"])
    p.add_argument("--remat", action="store_true", help="recompute biggan's residual blocks in the backward")
    p.add_argument("--critic", default="unconditional", choices=["unconditional", "projection"],
                   help="projection = condition the critic on the frozen VAE embedding; wganvae only")
    p.add_argument("--g_ema_decay", type=float, default=None,
                   help="generator weight EMA (e.g. 0.999); the FID probe and grids then use it")
    p.add_argument("--probe_train", action="store_true",
                   help="also record FID with train-mode (batch-statistics) BatchNorm in G")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.genes = 6, 12, 64
        args.size, args.batch, args.vae_epochs = 32, 4, 3
        args.epochs, args.fid_n, args.fid_batch = 2, 8, 8
    return args


def build_corpus(args, device):
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

    return SyntheticCorpus(n_slides=args.slides, tiles_per_slide=args.tiles_per_slide,
                           n_genes=args.genes, size=args.size, seed=args.corpus_seed, device=device)


def normalized_expression(corpus):
    """Host log + standardize, the training data path (reference
    ``read_data.py:467-495``); the scaler is kept for inversion."""
    from rnagan_tpu_torch.data.rna import Scaler, log_transform

    logged = log_transform(corpus.expression.cpu().numpy())
    scaler = Scaler.fit(logged, "standard")
    return scaler.transform(logged), scaler


def train_vae(args, expr_norm, device):
    """The beta-VAE pre-trained on the corpus expression (bfloat16, batch 64),
    the first fifth of the slides held out for validation: ``(state_dict of
    the best epoch on validation, model config, seconds)``. The matrix goes
    to the device once."""
    from rnagan_tpu_torch.core.config import VAEConfig, VAEModelConfig
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    model_cfg = VAEModelConfig(rna_features=expr_norm.shape[1], compute_dtype="bfloat16")
    trainer = VAETrainer(VAEConfig(model=model_cfg, num_epochs=args.vae_epochs, batch_size=64), device=device)
    data = torch.as_tensor(expr_norm).to(trainer.device)
    n_val = max(len(data) // 5, 1)
    t0 = time.perf_counter()
    best, info = trainer.fit(data[n_val:], data[:n_val])
    seconds = time.perf_counter() - t0
    print(f"[vae] {args.vae_epochs} epochs in {seconds:.1f}s, best val total {info['best_loss']['total_loss']:.4f} "
          f"at epoch {info['best_epoch']}", flush=True)
    return best.model.state_dict(), model_cfg, seconds


def vae_model_config(args):
    """The beta-VAE of a run (bfloat16): full width, or with ``--smoke`` the
    JAX tool's small one. The downstream tools build theirs here, so they
    load the ``vae_pretrain.pt`` a run of the same flags wrote."""
    from rnagan_tpu_torch.core.config import VAEModelConfig

    if args.smoke:
        return VAEModelConfig(rna_features=args.genes, z_dim=32, encoder_dims=(48, 32), decoder_dims=(48,),
                              compute_dtype="bfloat16")
    return VAEModelConfig(rna_features=args.genes, compute_dtype="bfloat16")


def smoke_vae(args):
    """A small random-init beta-VAE (the JAX tool's ``--smoke`` shapes)."""
    from rnagan_tpu_torch.models.betavae import BetaVAE

    cfg = vae_model_config(args)
    return BetaVAE(cfg, seed=0).state_dict(), cfg


def make_config(args, vae_cfg):
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig

    model_cfg = GANModelConfig(out_size=args.size, arch=args.arch,
                               encoding_dims=vae_cfg.z_dim if args.loss_type == "wganvae" else 2048,
                               critic=args.critic, remat=args.remat)
    kw = dict(model=model_cfg, loss_type=args.loss_type, batch_size=args.batch, vae=vae_cfg,
              compat_reference_gp=args.compat_gp, n_critic=args.n_critic, g_ema_decay=args.g_ema_decay)
    if args.no_clip:
        kw["clip"] = None
    for name in ("seed", "g_lr", "d_lr"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    return GANConfig(**kw)


def make_fid_probe(trainer, corpus, expr_dev, args):
    """``probe(state, epoch, train_mode=False) -> FID`` of fakes against
    held-out real tiles, with ``probe.floor`` (split-half real-vs-real FID)
    and ``probe.sample_grid(state, path, epoch)``.

    Random-init Inception activations come out tiny after 94 conv/BN layers:
    both sides are whitened with the real set's per-dimension mean and std,
    one fixed affine map, so the distance is still a Frechet distance in a
    fixed feature space, only well conditioned. Features, statistics and the
    distance stay on the device."""
    from rnagan_tpu_torch.core.rng import SeedStream
    from rnagan_tpu_torch.eval.fid import InceptionExtractor, activation_statistics, calculate_frechet_distance
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean, infused_noise
    from rnagan_tpu_torch.utils.images import save_image_grid

    dev = trainer.device
    weights = os.environ.get("INCEPTION_WEIGHTS")
    if weights:  # trained-weights parity path (docs/FID_WEIGHTS_RUNBOOK.md)
        from rnagan_tpu_torch.cli.common import load_inception_extractor

        extractor = load_inception_extractor(weights, device=dev)
        print(f"[fid] trained InceptionV3 features from {weights}", flush=True)
    else:
        extractor = InceptionExtractor(None, dtype="float32", seed=0, device=dev)
    chunk = min(args.fid_batch, args.fid_n)
    tps, span = corpus.tiles_per_slide, corpus.HELDOUT_SPAN
    seeds = SeedStream(4242)

    rng = np.random.RandomState(7117)
    real = []
    for i in range(0, args.fid_n, chunk):
        sl = rng.randint(0, corpus.n_slides, chunk)
        ti = tps + (i + np.arange(chunk)) % span  # held-out tile indices
        real.append(extractor.features((corpus.render(sl, ti) + 1.0) * 0.5))
    acts_r = torch.cat(real)[:args.fid_n].double()
    w_mu, w_sd = acts_r.mean(dim=0), acts_r.std(dim=0, correction=0) + 1e-8

    def stats(acts):
        return activation_statistics((acts.double() - w_mu) / w_sd)

    mu_r, s_r = stats(acts_r)
    half = len(acts_r) // 2
    floor = calculate_frechet_distance(*stats(acts_r[:half]), *stats(acts_r[half:]))
    del acts_r, real

    @torch.no_grad()
    def fake_images(state, seed, train_mode=False):
        """(chunk, H, W, 3) in [0, 1]: ``GANTrainer.sample`` (the EMA
        generator when the run keeps one), or with ``train_mode`` the raw
        weights with batch-statistics BatchNorm (a diagnostic that separates
        a broken G from broken running statistics)."""
        gene = None
        if expr_dev is not None:
            sl = np.random.RandomState(seed).randint(0, corpus.n_slides, chunk)
            gene = expr_dev[torch.from_numpy(sl).to(dev)]
        if not train_mode:
            imgs = trainer.sample(state, chunk, gene=gene, seed=seed)
        else:
            if gene is not None:
                noise = infused_noise(encode_z_mean(trainer.vae, gene), chunk, seed=seed,
                                      noise_range=trainer.cfg.noise_range)
            else:
                gen = torch.Generator(device=dev).manual_seed(seed)
                noise = torch.randn((chunk, trainer.cfg.model.encoding_dims), generator=gen, device=dev)
            imgs = state.generator.forward_stats(noise, state.g_stats, True)[0].permute(0, 2, 3, 1)
        return ((imgs.float() + 1.0) * 0.5).clamp(0.0, 1.0)

    def probe(state, epoch, train_mode=False):
        acts = torch.cat([extractor.features(fake_images(state, seeds.seed("fake", epoch, i), train_mode))
                          for i in range(0, args.fid_n, chunk)])[:args.fid_n]
        return calculate_frechet_distance(mu_r, s_r, *stats(acts))

    def sample_grid(state, path, epoch):
        imgs = fake_images(state, SeedStream(31337).seed("grid", epoch))
        save_image_grid((imgs[:64] * 255.0 + 0.5).to(torch.uint8), path, nrow=8)

    probe.floor = floor
    probe.sample_grid = sample_grid
    return probe


def epoch_record(fit_history, epoch, steps, fid_s=None):
    """The JAX tool's per-epoch record from ``fit``'s history entry."""
    h = fit_history
    rec = {"epoch": epoch, "d_loss": h["d_loss"], "g_loss": h["g_loss"], "gp": h.get("gp", 0.0),
           "train_s": round(h["step_ms_mean"] * steps / 1e3, 2), "step_ms": round(h["step_ms_mean"], 3)}
    for key in ("fid", "fid_train_mode"):
        if key in h:
            rec[key] = round(h[key], 4)
    if fid_s is not None:
        rec["fid_s"] = round(fid_s, 2)
    return rec


def run(args):
    from rnagan_tpu_torch.core.config import VAEModelConfig
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer
    from rnagan_tpu_torch.utils.images import save_image_grid

    dev = resolve_device(args.device)
    run_name = args.tag or args.loss_type
    out_path = args.out or os.path.join(args.workdir, f"{run_name}.json")
    os.makedirs(args.workdir, exist_ok=True)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[setup] device {dev} ({kind})", flush=True)

    t0 = time.perf_counter()
    corpus = build_corpus(args, dev)
    expr_norm, _scaler = normalized_expression(corpus)
    print(f"[setup] corpus + normalization {time.perf_counter() - t0:.1f}s", flush=True)

    vae_sd, vae_cfg = None, VAEModelConfig(rna_features=args.genes, compute_dtype="bfloat16")
    if args.loss_type == "wganvae":
        if args.smoke:
            vae_sd, vae_cfg = smoke_vae(args)
        else:
            from rnagan_tpu_torch.core.checkpoint import save_state_dict

            vae_sd, vae_cfg, _ = train_vae(args, expr_norm, dev)
            # the pre-trained VAE for downstream tools (representation analysis, data-plane runs)
            save_state_dict(os.path.join(args.workdir, "vae_pretrain.pt"), vae_sd)
    cfg = make_config(args, vae_cfg)
    trainer = GANTrainer(cfg, vae_sd, device=dev)
    expr_dev = torch.as_tensor(expr_norm).to(dev) if args.loss_type == "wganvae" else None

    steps_per_epoch = max((args.slides * args.tiles_per_slide) // args.batch, 1)
    t0 = time.perf_counter()
    probe = make_fid_probe(trainer, corpus, expr_dev, args)
    print(f"[setup] FID probe (incl. real-set activations) {time.perf_counter() - t0:.1f}s", flush=True)

    ckpt = os.path.join(args.workdir, f"{run_name}_last.model")
    ckpt_best = os.path.join(args.workdir, f"{run_name}_best.model")
    history, start_epoch = [], 0
    if args.resume and os.path.exists(ckpt) and os.path.exists(out_path):
        state = trainer.load_model(ckpt)
        with open(out_path) as f:
            prev = json.load(f)
        # the checkpoint may lag the history (saves every save_every epochs):
        # resume from the checkpointed step, dropping newer history rows
        start_epoch = state.step // steps_per_epoch
        history = prev["history"][:start_epoch]
        print(f"[resume] epoch {start_epoch} from {ckpt}", flush=True)
    else:
        state = trainer.init_state()

    if start_epoch == 0:  # one reference grid of held-out real tiles
        n_grid = min(64, args.slides)
        real_imgs = corpus.render(np.arange(n_grid) % args.slides, np.full(n_grid, args.tiles_per_slide))
        save_image_grid(real_imgs, os.path.join(args.workdir, "grids", "real.png"), nrow=8)

    meta = {"loss_type": args.loss_type, "slides": args.slides, "tiles_per_slide": args.tiles_per_slide,
            "batch": args.batch, "steps_per_epoch": steps_per_epoch, "size": args.size, "fid_n": args.fid_n,
            "fid_floor_real_vs_real": round(probe.floor, 4), "compat_reference_gp": cfg.compat_reference_gp,
            # the trainer clamps D only for the plain wgan loss
            "clip": cfg.clip if cfg.loss_type == "wgan" else None,
            "seed": cfg.seed, "arch": cfg.model.arch, "critic": cfg.model.critic, "n_critic": cfg.n_critic,
            "g_lr": cfg.g_lr, "d_lr": cfg.d_lr, "g_ema_decay": cfg.g_ema_decay, "remat": cfg.model.remat,
            "backend": dev.type, "device": kind}
    print(f"[run] {meta}", flush=True)

    best_fid, best_state, best_epoch = float("inf"), None, -1
    for r in history:
        if "fid" in r and r["fid"] < best_fid:
            best_fid, best_epoch = r["fid"], r["epoch"]
    for epoch in range(start_epoch, args.epochs):
        timing = {}

        def fid_probe(_epoch, st, _trainer, epoch=epoch):
            t1 = time.perf_counter()
            out = {"fid": probe(st, epoch)}
            if args.probe_train:
                out["fid_train_mode"] = probe(st, epoch, train_mode=True)
            timing["fid_s"] = time.perf_counter() - t1
            return out

        with_fid = bool(args.fid_every) and (epoch + 1) % args.fid_every == 0
        state, out = trainer.fit(
            lambda _e, epoch=epoch: corpus.batches(epoch, args.batch, steps_per_epoch, cfg.seed, expr_dev),
            num_epochs=1, state=state, eval_fn=fid_probe if with_fid else None, eval_every=1,
            keep_best_metric="fid")
        rec = epoch_record(out["history"][0], epoch, steps_per_epoch, timing.get("fid_s"))
        if "best" in out and out["best"]["fid"] < best_fid:
            best_fid, best_state, best_epoch = out["best"]["fid"], out["best"]["state"], epoch
        history.append(rec)
        print(f"[epoch {epoch}] " + " ".join(f"{k}={v}" for k, v in rec.items() if k != "epoch"), flush=True)
        with open(out_path, "w") as f:
            json.dump({"meta": meta, "history": history, "best": {"fid": best_fid, "epoch": best_epoch}},
                      f, indent=1)
        if (epoch + 1) % args.save_every == 0 or epoch == args.epochs - 1:
            if not args.no_ckpt:
                trainer.save_model(state, ckpt, epoch=epoch)
            probe.sample_grid(state, os.path.join(args.workdir, "grids", f"{run_name}_epoch{epoch:03d}.png"),
                              epoch)
    if best_state is not None:
        if not args.no_ckpt:
            trainer.save_model(best_state, ckpt_best, epoch=best_epoch)
            print(f"[best] fid {best_fid} at epoch {best_epoch} -> {ckpt_best}", flush=True)
        probe.sample_grid(best_state, os.path.join(
            args.workdir, "grids", f"{run_name}_best_epoch{best_epoch:03d}.png"), best_epoch)
    print(f"[done] {out_path}", flush=True)
    return {"meta": meta, "history": history, "best": {"fid": best_fid, "epoch": best_epoch}}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
