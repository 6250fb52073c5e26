"""Production data-plane proof on the PyTorch port: train wganvae through the
LMDB store path.

The counterpart of ``tools/data_plane_run.py``, on ``rnagan_tpu_torch`` (it
imports the port, numpy and the standard library only). It drives the path
the reference runs a step (``read_data.py:248-253``,
``histopathology_gan.py:163-168``) against the corpus of
``tools/make_lmdb_corpus_torch.py``:

  store (lz4 + LMDB, native bulk decode) -> ``StreamingPatchBatches`` (uint8,
  background ``Prefetcher``) -> copy to the card -> ``GANTrainer.train_step``
  (normalized to [-1, 1] on the card)

and reports, separately: the host pipeline's throughput alone (decode and
batch, no device); the step on a resident batch (no host pipeline); the
streamed step and its inflation over the resident one; the copy of a uint8
and of a float32 batch to the card; with ``--overlap_ab`` the three transfer
modes interleaved twice in one process. JSON keys are the JAX tool's.

The transfer hook runs in the ``Prefetcher``'s thread (:class:`CardCopy`):

* ``async_put`` (the default once the probes are done) copies each array
  from pinned memory on a side stream and records an event; the consumer
  makes the step's stream wait on it and ``record_stream``s the tensors, so
  the copy of batch N+1 overlaps the step on batch N and no buffer is reused
  while the step reads it. (A non-blocking copy from pageable memory would
  be synchronous anyway and would not measure the overlap.)
* ``blocking_put`` is a plain copy on the thread's current stream, then
  that stream's synchronize;
* ``none`` leaves the numpy batch for the step to copy.

Steps:

1. the corpus is rebuilt in-process by ``make_lmdb_corpus_torch.main`` when
   ``expression.csv`` is missing (the JAX tool used a subprocess only
   because its import pinned the JAX platform);
2. the expression log-transformed and standard-scaled (``data/rna.py``), a
   ``SlideTable`` with the corpus as every slide's ``patch_data_path``;
3. wganvae: the full-width beta-VAE (bfloat16) pre-trained ``--vae_epochs``
   epochs of uniform row draws, batch ``min(64, rows)``, Adam through K3;
4. the probes, the resident step, the overlap A/B and the streamed epochs of
   ``GANConfig()`` at ``--batch`` (K1 and K3 twice a wganvae step).

``--device`` replaces ``--platform`` (default ``cuda``; the CPU only when
asked); ``--probe_only`` touches no device. ``--smoke`` (tiny shapes) is
new. Draws come from seeds: the VAE's rows from ``SeedStream(11)`` (the JAX
tool's key 11), the GAN's from its config's seed.

Usage:
  python tools/data_plane_run_torch.py --corpus runs/corpus --epochs 2 --batch 32 \\
      --out docs/quality/data_plane_torch.json
  python tools/data_plane_run_torch.py --smoke --device cpu --corpus <dir> --out <file>
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

#: the key of a batch's card-copy event, taken out before the step sees the batch
_EVENT = "_copy_event"


def build_parser():
    p = argparse.ArgumentParser(description="wganvae trained through the LMDB data plane")
    p.add_argument("--corpus", default="runs/corpus")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max_patches_total", type=int, default=600)
    p.add_argument("--vae_epochs", type=int, default=40)
    p.add_argument("--loss_type", default="wganvae", choices=["wganvae", "wgan"])
    p.add_argument("--host_probe_batches", type=int, default=150,
                   help="batches for the host-pipeline-only throughput probe")
    p.add_argument("--resident_steps", type=int, default=60,
                   help="steps for the device-only (resident batch) baseline")
    p.add_argument("--limit_slides", type=int, default=None,
                   help="use only the first N corpus slides (smoke runs)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--prewarm", action="store_true",
                   help="sequentially fault the corpus into page cache before the probes "
                        "(random cold reads are disk-seek-bound)")
    p.add_argument("--probe_only", action="store_true",
                   help="host-pipeline probe only (no device work), then exit")
    p.add_argument("--overlap_ab", type=int, default=0, metavar="STEPS",
                   help="bounded A/B of the transfer modes (no hook / async copy in the prefetch thread / "
                        "blocking copy), interleaved x2 in one process")
    p.add_argument("--slides", type=int, default=200,
                   help="corpus scale used when the corpus must be (re)built")
    p.add_argument("--tiles_per_slide", type=int, default=600)
    p.add_argument("--out", default="docs/quality/data_plane.json")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.batch, args.max_patches_total = 4, 8, 4, 8
        args.vae_epochs, args.host_probe_batches, args.resident_steps, args.epochs = 2, 4, 2, 1
    return args


def model_configs(args, genes: int):
    """``(GANModelConfig, VAEModelConfig)``: ``GANConfig()``'s generator and
    the full-width beta-VAE in bfloat16 (the JAX tool's), or with ``--smoke``
    the small ones of ``make_lmdb_corpus_torch --smoke``'s 32x32 tiles."""
    from quality_run_torch import vae_model_config

    from rnagan_tpu_torch.core.config import GANModelConfig

    vae_cfg = vae_model_config(argparse.Namespace(smoke=args.smoke, genes=genes))
    if args.smoke:
        return GANModelConfig(out_size=32, encoding_dims=vae_cfg.z_dim, step_channels=8), vae_cfg
    return GANModelConfig(), vae_cfg


def pretrain_vae(expr_norm: np.ndarray, epochs: int, model_cfg, device):
    """A short beta-VAE pre-train on the corpus expression, held on the card
    (the JAX tool's resident-matrix scan): ``epochs * max(rows // batch, 1)``
    steps of ``batch = min(64, rows)`` rows drawn uniformly with replacement
    from each step's seed (``VAETrainer.run_resident``), one K3 launch a
    step. Returns its state_dict."""
    from rnagan_tpu_torch.core.config import VAEConfig
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    trainer = VAETrainer(VAEConfig(model=model_cfg, num_epochs=epochs, batch_size=64), device=device)
    train_dev = torch.as_tensor(expr_norm, dtype=torch.float32).to(trainer.device)
    batch = min(64, len(expr_norm))
    state = trainer.init_state()
    tl = trainer.run_resident(state, train_dev, epochs * max(len(expr_norm) // batch, 1), batch)
    print(f"[vae] {epochs} epochs, final train loss {float(tl):.4f}", flush=True)
    return state.model.state_dict()


class CardCopy:
    """A ``StreamingPatchBatches.transfer`` hook: copies a batch's arrays to
    ``device`` in the prefetch thread. ``blocking=False`` copies from pinned
    memory on a side stream and attaches an event that :meth:`ready` makes
    the consumer's stream wait on; ``blocking=True`` copies on the thread's
    stream and synchronizes it. On the CPU both are plain conversions."""

    def __init__(self, device, blocking: bool):
        self.device, self.blocking = device, blocking
        self.side = torch.cuda.Stream(device) if device.type == "cuda" and not blocking else None

    def __call__(self, batch):
        if self.side is None:
            out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            return out
        with torch.cuda.stream(self.side):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.side)
        out[_EVENT] = event
        return out

    @staticmethod
    def ready(batch):
        """The batch for a step on the current stream: it waits for the copy
        and keeps the copied tensors from reuse until the step is done."""
        event = batch.pop(_EVENT, None) if isinstance(batch, dict) else None
        if event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch


def slide_table(args):
    """The corpus's expression, log-transformed and standard-scaled (reference
    ``read_data.py:467-495``), as a ``SlideTable`` whose slides all live
    under ``--corpus``."""
    from rnagan_tpu_torch.data.patches import SlideTable
    from rnagan_tpu_torch.data.rna import RNATable, Scaler, log_transform

    rna = RNATable.read_csv(os.path.join(args.corpus, "expression.csv"))
    if args.limit_slides:
        rna = rna.take(np.arange(min(args.limit_slides, len(rna))))
    logged = log_transform(rna.values.astype(np.float32))
    scaled = Scaler.fit(logged, "standard").transform(logged).astype(np.float32)
    n = len(rna)
    return SlideTable(rna.with_values(scaled), np.array([args.corpus] * n, dtype=object), np.zeros(n, np.int64))


def main(argv=None):
    args = parse_args(argv)
    from rnagan_tpu_torch.core.config import GANConfig
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.patches import StreamingPatchBatches
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    dev = None if args.probe_only else resolve_device(args.device)  # the host probe runs no device work

    # the corpus lives in scratch: a wiped one is rebuilt (deterministic in the
    # seed, resumable a slide at a time)
    if not os.path.exists(os.path.join(args.corpus, "expression.csv")):
        import make_lmdb_corpus_torch

        print(f"[setup] corpus missing at {args.corpus}; rebuilding ({args.slides}x{args.tiles_per_slide})",
              flush=True)
        make_lmdb_corpus_torch.main(["--out", args.corpus, "--slides", str(args.slides), "--tiles_per_slide",
                                     str(args.tiles_per_slide), "--device", args.device]
                                    + (["--smoke"] if args.smoke else []))

    kind = "none" if dev is None else torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[setup] device {dev} ({kind})", flush=True)
    table = slide_table(args)
    genes = table.rna.values.shape[1]
    with_rna = args.loss_type == "wganvae"
    gan_model, vae_cfg = model_configs(args, genes)
    vae_sd = None
    if with_rna and not args.probe_only:
        vae_sd = pretrain_vae(table.rna.values, args.vae_epochs, vae_cfg, dev)

    t0 = time.time()
    batches = StreamingPatchBatches(table, batch_size=args.batch, max_patches_total=args.max_patches_total,
                                    with_rna=with_rna, emit_uint8=True, prefetch_depth=4, prewarm=args.prewarm)
    n_tiles = len(batches) * args.batch
    print(f"[setup] streaming index: {n_tiles} tiles, {len(batches)} batches/epoch ({time.time() - t0:.1f}s)",
          flush=True)
    if args.prewarm:
        t0 = time.time()
        batches.wait_prewarm()
        print(f"[setup] corpus prewarm: {time.time() - t0:.1f}s", flush=True)

    # ---- host-pipeline-only probe (decode + batch assembly, no device)
    t0 = time.time()
    n = 0
    for _ in batches.epoch(999):
        n += 1
        if n >= args.host_probe_batches:
            break
    host_s_per_batch = (time.time() - t0) / n
    host_tiles_s = args.batch / host_s_per_batch
    print(f"[host] pipeline-only: {host_tiles_s:.0f} tiles/s ({host_s_per_batch * 1e3:.1f} ms/batch of "
          f"{args.batch})", flush=True)
    if args.probe_only:
        batches.close()
        return {"host_pipeline_tiles_per_s": round(host_tiles_s, 1),
                "host_ms_per_batch": round(host_s_per_batch * 1e3, 2)}

    # ---- trainer
    cfg = GANConfig(model=gan_model, loss_type=args.loss_type, batch_size=args.batch, vae=vae_cfg)
    trainer = GANTrainer(cfg, vae_sd, device=dev)
    state = trainer.init_state()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- host->card copy probe: a uint8 against a float32 batch, pageable memory
    sample = next(iter(batches.epoch(998)))
    xfer = {}
    for name, arr in (("uint8", sample["image"]), ("float32", sample["image"].astype(np.float32) / 127.5 - 1.0)):
        torch.as_tensor(arr).to(dev)  # warm
        sync()
        t0 = time.time()
        for _ in range(4):
            torch.as_tensor(arr).to(dev)
            sync()
        xfer[name] = (time.time() - t0) / 4
    print(f"[xfer] copy to {dev} per batch: uint8 {xfer['uint8'] * 1e3:.1f} ms, float32 "
          f"{xfer['float32'] * 1e3:.1f} ms", flush=True)

    # overlap the copy with the step: the Prefetcher's thread copies batch N+1
    # while the card runs batch N
    modes = {"none": None, "async_put": CardCopy(dev, blocking=False), "blocking_put": CardCopy(dev, blocking=True)}
    batches.transfer = modes["async_put"]
    ready = CardCopy.ready

    # ---- device-only baseline: a resident batch, the same step
    resident = {k: torch.as_tensor(v).to(dev) for k, v in sample.items()}
    state, _ = trainer.train_step(state, resident)  # first calls: cuDNN's choices, allocations
    sync()
    t0 = time.time()
    for _ in range(args.resident_steps):
        state, m = trainer.train_step(state, resident)
    sync()
    resident_ms = (time.time() - t0) / args.resident_steps * 1e3
    print(f"[device] resident-batch step: {resident_ms:.1f} ms", flush=True)

    # ---- optional bounded overlap A/B (one process, interleaved reps)
    overlap_ab = {}
    if args.overlap_ab:
        ab = {k: [] for k in modes}
        for rep in range(2):
            for mname, hook in modes.items():
                batches.transfer = hook
                it = iter(batches.epoch(100 + rep))
                state, m = trainer.train_step(state, ready(next(it)))
                sync()
                t0 = time.time()
                n = 0
                for b in it:
                    state, m = trainer.train_step(state, ready(b))
                    n += 1
                    if n >= args.overlap_ab:
                        break
                sync()
                ab[mname].append((time.time() - t0) / max(n, 1) * 1e3)
                print(f"[overlap-ab rep{rep}] {mname}: {ab[mname][-1]:.1f} ms/step", flush=True)
        overlap_ab = {k: [round(v, 1) for v in vs] for k, vs in ab.items()}
        batches.transfer = modes["async_put"]

    # ---- end to end: epochs through the streaming pipeline
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.time()
        count = 0
        for batch in batches.epoch(epoch):
            state, m = trainer.train_step(state, ready(batch))
            count += 1
        sync()
        dt = time.time() - t0
        rec = {"epoch": epoch, "steps": count, "wall_s": round(dt, 2),
               "step_ms": round(dt / count * 1e3, 2),
               "tiles_per_s": round(count * args.batch / dt, 1),
               "d_loss": float(m["d_loss"]), "g_loss": float(m["g_loss"])}
        epochs.append(rec)
        print(f"[epoch {epoch}] " + " ".join(f"{k}={v}" for k, v in rec.items()), flush=True)

    e2e_ms = epochs[-1]["step_ms"] if epochs else None
    result = {
        "meta": {"corpus": args.corpus, "slides": len(table), "tiles": n_tiles,
                 "batch": args.batch, "loss_type": args.loss_type,
                 "device": f"{dev} ({kind})",
                 "host_cores": os.cpu_count()},
        "host_pipeline_tiles_per_s": round(host_tiles_s, 1),
        "host_ms_per_batch": round(host_s_per_batch * 1e3, 2),
        "device_put_ms": {k: round(v * 1e3, 2) for k, v in xfer.items()},
        "resident_step_ms": round(resident_ms, 2),
        "e2e_step_ms": e2e_ms,
        "inflation_vs_resident": round(e2e_ms / resident_ms, 3) if e2e_ms else None,
        "epochs": epochs,
    }
    if overlap_ab:
        result["overlap_ab_ms"] = overlap_ab
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[done] {args.out}", flush=True)
    batches.close()
    return result


if __name__ == "__main__":
    main()
