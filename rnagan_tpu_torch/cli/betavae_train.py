"""β-VAE training CLI (port of ``rnagan_tpu/cli/betavae_train.py``, the flag
surface of reference ``src/betaVAE_training.py``):

    python -m rnagan_tpu_torch.cli.betavae_train --config configs/betavae_tissues.json \\
        [--checkpoint model.pt] [--log] [--seed 99] [--device cuda]

split (per tissue 64/16/20) -> normalize (scaler fit on train) -> fit
(best-on-val ``model_dict_best.pt``, ``model_last.pt`` and ``scaler.npz`` in
the config's ``save_dir``) -> test evaluation -> ``test_results.pkl`` there
(inverse-scaled predictions and inputs, test ids and tissue labels).
``--checkpoint`` starts from a betaVAE ``.pt`` state_dict with a fresh
optimizer, as the JAX CLI does. Under torchrun every rank goes on the data
axis (``--dist_backend``, NCCL by default); rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from rnagan_tpu_torch.cli.common import add_dist_arguments, dump_pickle, training_mesh


def build_parser():
    p = argparse.ArgumentParser(description="betaVAE training on RNA-seq data")
    p.add_argument("--config", type=str, required=True, help="JSON config file")
    p.add_argument("--checkpoint", type=str, default=None, help="betaVAE .pt state_dict to start from")
    p.add_argument("--log", action="store_true", help="write a JSONL log (and tensorboardX if installed)")
    p.add_argument("--parallel", action="store_true",
                   help="accepted for reference-CLI parity; under torchrun every rank trains")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    add_dist_arguments(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core.config import load_reference_json, vae_config_from_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.core.metrics import MetricsLogger
    from rnagan_tpu_torch.data.rna import load_tissue_splits, normalize_dfs, rna_matrix
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    resolve_device(args.device)  # before any data is read
    config = load_reference_json(args.config)
    print("-" * 10)
    print("Config for this experiment\n")
    print(config)
    print("-" * 10)

    cfg = dataclasses.replace(vae_config_from_json(config), seed=args.seed)
    save_dir = config.get("save_dir", "checkpoints/betavae")

    train, val, test, test_labels = load_tissue_splits(
        config["path_csv"], seed=args.seed, quick=bool(config.get("quick", False)))
    print(f"Train shape {train.shape}\nVal shape {val.shape}\nTest shape {test.shape}")
    train, val, test, scaler = normalize_dfs(train, val, test, "standard")

    logger = MetricsLogger(log_dir=config.get("summary_path") if args.log else None,
                           use_tensorboard=args.log, run_name=config.get("flag", "betavae"))
    trainer = VAETrainer(cfg, logger=logger, mesh=training_mesh(args, cfg.mesh))
    state = None
    if args.checkpoint:
        state = trainer.init_state()
        state.model.load_state_dict(convert.load_betavae_state_dict(args.checkpoint))

    state, results = trainer.fit(rna_matrix(train), rna_matrix(val), save_dir=save_dir, scaler=scaler,
                                 state=state)
    print(f"Best epoch {results['best_epoch']} best val loss {results['best_loss']}")

    test_losses, predictions = trainer.evaluate(rna_matrix(test), state)
    print("Test:", test_losses)
    if trainer.mesh.writer:
        dump_pickle(os.path.join(save_dir, "test_results.pkl"), {
            "predictions": scaler.inverse_transform(predictions),
            "real": scaler.inverse_transform(rna_matrix(test)),
            "test_ids": test.wsi_file_name if test.wsi_file_name is not None else np.arange(len(test)),
            "test_labels": np.asarray(test_labels),
        })
    logger.close()
    return results


if __name__ == "__main__":
    main()
