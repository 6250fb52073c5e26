"""Synthetic expression sampling CLI (port of ``rnagan_tpu/cli/sample.py``, the
reference ``src/betaVAE_sample.py`` surface, ``--device`` in place of
``--platform``):

    python -m rnagan_tpu_torch.cli.sample --config CFG --checkpoint model_dict_best.pt \\
        --num_samples 100 [--interpolation interp.pkl --pair 0,1 --alpha 1.0] \\
        --save_path samples.pkl

``--checkpoint`` is a betaVAE ``.pt`` (its ``scaler.npz`` beside it) or a JAX
``model_best.ckpt`` (its scaler bundled). Without a saved scaler the CSVs
are split again and the scaler re-fit, as the reference does
(``betaVAE_sample.py:66-96``). The latents come from a ``torch.Generator``
seeded with ``--seed``, where the JAX CLI draws from ``jax.random.key(seed)``:
the same seed gives the same samples within each package.
"""

from __future__ import annotations

import argparse
import pickle

from rnagan_tpu_torch.cli.common import dump_pickle


def build_parser():
    p = argparse.ArgumentParser(description="Sample synthetic gene expression from a trained beta-VAE")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--interpolation", type=str, default=None, help="pickle from the interpolate CLI")
    p.add_argument("--pair", type=str, default=None, help="class pair 'a,b' inside the interpolation file")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--save_path", type=str, default="sampled_expression.pkl")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from rnagan_tpu_torch.cli.common import load_vae
    from rnagan_tpu_torch.core.config import load_reference_json, vae_config_from_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.rna import load_tissue_splits, normalize_dfs
    from rnagan_tpu_torch.eval.sample import sample_expression

    device = resolve_device(args.device)  # before anything is read
    config = load_reference_json(args.config)
    cfg = vae_config_from_json(config)
    model, scaler, meta = load_vae(args.checkpoint, cfg.model, device)
    if scaler is None:
        train, val, test, _ = load_tissue_splits(config["path_csv"], seed=args.seed)
        scaler = normalize_dfs(train, val, test)[3]

    direction = None
    if args.interpolation:
        with open(args.interpolation, "rb") as f:
            report = pickle.load(f)
        pair = (tuple(int(x) for x in args.pair.split(",")) if args.pair
                else next(iter(report["difference_vectors"])))
        direction = report["difference_vectors"][pair]

    gen = torch.Generator(device=device).manual_seed(args.seed)
    expr = sample_expression(model, scaler, args.num_samples, gen, interpolation=direction, alpha=args.alpha)
    dump_pickle(args.save_path, {"expression": expr, "meta": meta})
    print(f"wrote {args.save_path}: {expr.shape}")
    return expr


if __name__ == "__main__":
    main()
