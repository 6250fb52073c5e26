"""The downstream ML experiment at corpus scale on the PyTorch port.

The counterpart of ``tools/ml_experiment_run.py``, on ``rnagan_tpu_torch``
(it imports the port, numpy and the standard library only). The reference's
downstream result is a ResNet50 tile classifier (TCGA-GBM vs TCGA-LUAD,
5-fold stratified CV, accuracy and weighted F1, ``ml_experiments.py:282-362``)
trained on real tiles and, separately, on RNA-GAN tiles. This runs that
protocol on the two-tissue procedural corpus:

* ``real``: CV on rendered training-range tiles, each fold's best-on-val
  model also scored on a held-out real test set;
* ``rnagan_synthetic``: the same, trained on tiles that the ``--ckpt_name``
  checkpoint generates from each patient's expression (label: the patient's
  tissue), tested on the real held-out set;
* ``mixed``: real and synthetic pooled, tested on the same real set.

Tiles are rendered or generated on the card straight into a uint8 set at
``--image_size`` that stays there (``TileClassifierTrainer.fit_resident``):

* the resize is ``jax.image.resize(..., "bilinear")``'s, which antialiases
  when it shrinks (``eval/fid.py::resize_bilinear``, not ``F.interpolate``);
* the uint8 cast is ``clip(x * 255 + 0.5, 0, 255)`` truncated, round half up;
* generation draws the infused noise in reference mode through K1, one
  launch a chunk of 64 rows, standardized over the chunk: the last chunk is
  padded with slide-0 rows as the JAX tool pads it, so the kept rows see the
  same batch statistics. Chunk i takes seed ``seed + i`` (the JAX tool's
  ``fold_in(key(seed), i)``).

Each finished arm is written to ``--out`` at once, and a rerun keeps the
arms an earlier run of the same pool finished. Without a checkpoint and
``vae_pretrain.pt`` in ``--workdir`` the synthetic arms are recorded as
``rnagan_synthetic_skipped`` and the real arm still runs.

``--device`` replaces ``--platform`` (default ``cuda``; the CPU only when
asked); ``--smoke`` (tiny shapes, ResNet18) is new.

Usage:
  python tools/ml_experiment_run_torch.py --workdir runs/quality --out docs/quality/ml_experiment_torch.json
  python tools/ml_experiment_run_torch.py --smoke --device cpu --workdir <dir> --out <file>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: rows a render or generation chunk
CHUNK = 64


def build_parser():
    p = argparse.ArgumentParser(description="tile-classifier CV on real, RNA-GAN and mixed tiles")
    p.add_argument("--workdir", default="runs/quality")
    p.add_argument("--slides", type=int, default=200)
    p.add_argument("--tiles_per_slide", type=int, default=600)
    p.add_argument("--genes", type=int, default=19198)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--tiles_per_slide_cls", type=int, default=25,
                   help="training tiles per slide (200 x 25 = 5k, reference scale)")
    p.add_argument("--test_tiles_per_slide", type=int, default=10)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--ckpt_name", default="wganvae",
                   help="GAN checkpoint prefix in --workdir ({name}_best.model or {name}_last.model), "
                        "e.g. wganvae_proj for the projection-critic arm")
    p.add_argument("--synth_tiles_per_slide", type=int, default=None,
                   help="synthetic tiles per slide for the synthetic/mixed arms (default: "
                        "--tiles_per_slide_cls)")
    p.add_argument("--skip_real", action="store_true",
                   help="skip the real-tiles arm (e.g. transfer-only reruns from another GAN checkpoint)")
    p.add_argument("--skip_synthetic", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--out", default="docs/quality/ml_experiment.json")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.genes, args.size = 8, 12, 64, 32
        args.tiles_per_slide_cls, args.test_tiles_per_slide = 4, 2
        args.image_size, args.epochs, args.folds, args.batch, args.arch = 32, 1, 2, 8, "resnet18"
    return args


def to_uint8(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats -> uint8 as ``clip(x * 255 + 0.5, 0, 255)`` truncated: round half up."""
    return torch.clamp(images01 * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def to_uint8_resized(images01: torch.Tensor, out_size: int) -> torch.Tensor:
    """[0, 1] NHWC floats -> uint8 NHWC at ``out_size``: ``jax.image.resize``'s
    antialiased bilinear resize, then :func:`to_uint8`."""
    from rnagan_tpu_torch.eval.fid import resize_bilinear

    return to_uint8(resize_bilinear(images01, out_size))


def render_set_u8(corpus, slide_ids: np.ndarray, tile_ids: np.ndarray, out_size: int,
                  chunk: int = CHUNK) -> torch.Tensor:
    """Render (slide, tile) pairs on the corpus's device a chunk at a time,
    resize to ``out_size``: uint8 NHWC on that device. (A render has no batch
    statistic, so the last chunk needs none of the JAX tool's padding.)"""
    out = [to_uint8_resized((corpus.render(slide_ids[i:i + chunk], tile_ids[i:i + chunk]) + 1.0) * 0.5, out_size)
           for i in range(0, len(slide_ids), chunk)]
    return torch.cat(out)


@torch.no_grad()
def generated_chunks(trainer, state, expr_norm, slide_ids: np.ndarray, out_size: int, chunk: int = CHUNK,
                     seed: int = 777, uniforms=None):
    """RNA-GAN tiles conditioned per slide, a chunk at a time: [0, 1] NHWC
    floats at ``out_size`` on the trainer's device, before the uint8 cast.
    Chunks of ``chunk`` rows, the last one padded with slide-0 rows (yielded
    with its padding); per chunk the frozen VAE's z_mean, K1's infused noise
    in reference mode (standardized over the chunk, padding included; seed
    ``seed + i``, or ``uniforms[i]``, the chunk's (chunk, z) uniforms), G in
    eval mode on its raw weights, [0, 1] and the resize."""
    from rnagan_tpu_torch.eval.fid import resize_bilinear
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean, infused_noise

    dev = trainer.device
    expr_dev = torch.as_tensor(expr_norm, dtype=torch.float32).to(dev)
    n = len(slide_ids)
    sl = np.concatenate([np.asarray(slide_ids, np.int64), np.zeros((-n) % chunk, np.int64)])
    for i, start in enumerate(range(0, len(sl), chunk)):
        z_mean = encode_z_mean(trainer.vae, expr_dev[torch.from_numpy(sl[start:start + chunk]).to(dev)])
        draw = {"seed": seed + i} if uniforms is None else {"u": torch.as_tensor(uniforms[i]).to(dev)}
        noise = infused_noise(z_mean, noise_range=trainer.cfg.noise_range, **draw)
        imgs = state.generator.forward_stats(noise, state.g_stats, False)[0].permute(0, 2, 3, 1)
        yield resize_bilinear(torch.clamp((imgs.float() + 1.0) * 0.5, 0.0, 1.0), out_size)


@torch.no_grad()
def generate_set_u8(trainer, state, expr_norm, slide_ids: np.ndarray, out_size: int, chunk: int = CHUNK,
                    seed: int = 777, uniforms=None) -> torch.Tensor:
    """:func:`generated_chunks` cast to uint8 (round half up), the padding
    dropped: (len(slide_ids), out_size, out_size, 3) on the trainer's device."""
    out = [to_uint8(x) for x in generated_chunks(trainer, state, expr_norm, slide_ids, out_size, chunk, seed,
                                                   uniforms)]
    return torch.cat(out)[:len(slide_ids)]


def cv_resident(images_u8, labels, test_u8, test_labels, cfg, verbose=False, device="cuda", model=None):
    """The CV protocol on card-resident uint8 sets: per fold a fresh
    classifier through ``fit_resident``, its best-on-val state scored on the
    fold and on the test set. The JAX tool's record: ``folds`` and the
    ``mean_*`` of validation and test accuracy and weighted F1."""
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer, stratified_folds, weighted_f1

    images = torch.as_tensor(images_u8)
    labels, test_labels = np.asarray(labels), np.asarray(test_labels)
    results = {"folds": []}
    for f, (tr_idx, va_idx) in enumerate(stratified_folds(labels, cfg.folds, cfg.seed)):
        t0 = time.time()
        trainer = TileClassifierTrainer(cfg, model=model, device=device)
        tr, va = (torch.from_numpy(idx).to(images.device) for idx in (tr_idx, va_idx))
        state, fit_res = trainer.fit_resident(images[tr], labels[tr_idx], images[va], labels[va_idx],
                                              verbose=verbose)
        va_pred = trainer.predict_resident(images[va], state)
        fold = {"fold": f,
                "accuracy": float(np.mean(va_pred == labels[va_idx])),
                "weighted_f1": weighted_f1(labels[va_idx], va_pred, cfg.num_classes),
                "best_val_acc": fit_res["best_val_acc"]}
        te_pred = trainer.predict_resident(test_u8, state)
        fold["test"] = {"accuracy": float(np.mean(te_pred == test_labels)),
                        "weighted_f1": weighted_f1(test_labels, te_pred, cfg.num_classes)}
        fold["wall_s"] = round(time.time() - t0, 1)
        results["folds"].append(fold)
        print(f"  [fold {f}] val acc={fold['accuracy']:.4f} f1={fold['weighted_f1']:.4f} "
              f"test acc={fold['test']['accuracy']:.4f} ({fold['wall_s']}s)", flush=True)
        trainer.step_graphs.release()  # the fold's graphs and their pools, before the next fold captures its own
        del state, trainer
    for k in ("accuracy", "weighted_f1"):
        results[f"mean_{k}"] = float(np.mean([x[k] for x in results["folds"]]))
        results[f"mean_test_{k}"] = float(np.mean([x["test"][k] for x in results["folds"]]))
    return results


def load_generator(args, device):
    """The ``--ckpt_name`` wganvae trainer and state; a name with ``proj``
    loads with the projection critic (its D carries the conditioning head)."""
    from representation_run_torch import gan_configs, load_vae, pick_ckpt

    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    vae_sd, vae_cfg = load_vae(args)
    cfg, _ = gan_configs(args, vae_cfg, "projection" if "proj" in args.ckpt_name else "unconditional")
    trainer = GANTrainer(cfg, vae_sd, device=device)
    path = pick_ckpt(args.workdir, args.ckpt_name)
    return trainer, trainer.load_model(path), path


def main(argv=None):
    args = parse_args(argv)
    from quality_run_torch import build_corpus, normalized_expression

    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[setup] device {dev} ({kind})", flush=True)
    corpus = build_corpus(args, dev)
    tissue = corpus.slides.tissue.cpu().numpy()

    # ---- real training pool: tiles_per_slide_cls tiles a slide, training range
    k = args.tiles_per_slide_cls
    slide_ids = np.repeat(np.arange(args.slides, dtype=np.int64), k)
    tile_ids = np.tile(np.arange(k, dtype=np.int64), args.slides)  # deterministic subset
    labels = tissue[slide_ids].astype(np.int64)
    t0 = time.time()
    real_train = render_set_u8(corpus, slide_ids, tile_ids, args.image_size)
    # ---- held-out real test set (indices past the training range)
    kt = args.test_tiles_per_slide
    t_slides = np.repeat(np.arange(args.slides, dtype=np.int64), kt)
    t_tiles = np.tile(corpus.tiles_per_slide + np.arange(kt, dtype=np.int64), args.slides)
    test_labels = tissue[t_slides].astype(np.int64)
    real_test = render_set_u8(corpus, t_slides, t_tiles, args.image_size)
    print(f"[data] real train {tuple(real_train.shape)}, test {tuple(real_test.shape)} ({time.time() - t0:.1f}s)",
          flush=True)

    cfg = MLConfig(num_epochs=args.epochs, batch_size=args.batch, folds=args.folds,
                   image_size=args.image_size, arch=args.arch)
    k_s = args.synth_tiles_per_slide or k
    result = {"meta": {"slides": args.slides, "train_tiles": len(real_train),
                       "test_tiles": len(real_test), "epochs": args.epochs,
                       "folds": args.folds, "arch": args.arch,
                       "image_size": args.image_size,
                       "tiles_per_slide_cls": k, "synth_tiles_per_slide": k_s,
                       "device": f"{dev} ({kind})"}}

    def flush_partial():
        # every finished arm's numbers are on disk before the next one starts
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    result["meta"]["ckpt_name"] = args.ckpt_name
    if os.path.exists(args.out):
        # resume: keep arms a previous invocation finished. The real arm needs
        # the same real pool; the synthetic arms also the same checkpoint and
        # synthetic pool size.
        try:
            with open(args.out) as f:
                prev = json.load(f)
            pm = prev.get("meta", {})
            if pm.get("train_tiles") == len(real_train) and "real" in prev:
                result["real"] = prev["real"]
                print(f"[resume] variant 'real' from {args.out}", flush=True)
            if (pm.get("train_tiles") == len(real_train)
                    and pm.get("synth_tiles_per_slide", k) == k_s
                    and pm.get("ckpt_name", "wganvae") == args.ckpt_name):
                for kk in ("rnagan_synthetic", "mixed"):
                    if kk in prev:
                        result[kk] = prev[kk]
                        print(f"[resume] variant '{kk}' from {args.out}", flush=True)
        except (OSError, ValueError, AttributeError):  # an unreadable or foreign file: start afresh
            pass

    if args.skip_real:
        result.setdefault("real_skipped", "--skip_real")
    elif "real" not in result:
        print(f"[real] {args.folds}-fold CV on real tiles", flush=True)
        result["real"] = cv_resident(real_train, labels, real_test, test_labels, cfg, args.verbose, dev)
        flush_partial()

    have_ckpt = os.path.exists(os.path.join(args.workdir, "vae_pretrain.pt")) and any(
        os.path.exists(os.path.join(args.workdir, f"{args.ckpt_name}_{s}.model")) for s in ("best", "last"))
    if not args.skip_synthetic and not have_ckpt:
        # the workdir is scratch: a wiped one must not take down the real arm's numbers
        print(f"[synth] SKIPPED: no {args.ckpt_name} checkpoint/VAE in {args.workdir}", flush=True)
        result["rnagan_synthetic_skipped"] = f"no {args.ckpt_name} checkpoint in {args.workdir}"
    if not args.skip_synthetic and have_ckpt and "mixed" in result:
        pass  # both synthetic-based arms already resumed from disk
    elif not args.skip_synthetic and have_ckpt:
        expr_norm, _ = normalized_expression(corpus)
        rna_trainer, rna_state, ckpt = load_generator(args, dev)
        s_slide_ids = np.repeat(np.arange(args.slides, dtype=np.int64), k_s)
        s_labels = tissue[s_slide_ids].astype(np.int64)
        print(f"[synth] generating {len(s_slide_ids)} RNA-GAN tiles from {ckpt}", flush=True)
        t0 = time.time()
        synth_train = generate_set_u8(rna_trainer, rna_state, expr_norm, s_slide_ids, args.image_size)
        print(f"[synth] generated in {time.time() - t0:.1f}s", flush=True)
        del rna_trainer, rna_state
        result["meta"]["rnagan_ckpt"] = ckpt
        if "rnagan_synthetic" not in result:
            print(f"[synth] {args.folds}-fold CV on RNA-GAN tiles, tested on real held-out", flush=True)
            result["rnagan_synthetic"] = cv_resident(synth_train, s_labels, real_test, test_labels, cfg,
                                                     args.verbose, dev)
            flush_partial()
        # the reference protocol's augmentation direction: real + synthetic
        # pooled, the same held-out real test set
        if "mixed" not in result and not args.skip_real:
            print(f"[mixed] {args.folds}-fold CV on real+RNA-GAN tiles, tested on real held-out", flush=True)
            result["mixed"] = cv_resident(torch.cat([real_train, synth_train]),
                                          np.concatenate([labels, s_labels]), real_test, test_labels, cfg,
                                          args.verbose, dev)
            flush_partial()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    summary = {k: {kk: round(vv, 4) for kk, vv in v.items() if kk.startswith("mean")}
               for k, v in result.items() if isinstance(v, dict) and "folds" in v}
    print(f"[done] {args.out}\n" + json.dumps(summary, indent=1), flush=True)
    return result


if __name__ == "__main__":
    main()
