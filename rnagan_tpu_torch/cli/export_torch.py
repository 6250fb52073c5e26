"""Convert a GAN checkpoint to the reference's torchgan ``.model`` format, or
to the JAX package's msgpack bundle (port of ``rnagan_tpu/cli/export_torch.py``,
``--device`` in place of ``--platform``):

    python -m rnagan_tpu_torch.cli.export_torch --config CFG \\
        --checkpoint gan_last.model --out rna-gan_brain.model [--epoch N]
    python -m rnagan_tpu_torch.cli.export_torch --config CFG \\
        --checkpoint rna-gan_brain.model --out gan_last.msgpack --to_native

``GANTrainer.load_model`` reads either format. The torchgan direction writes
``convert.save_training_bundle`` (``dcgan`` only, as the JAX package's
``export_torchgan_bundle``); ``--to_native`` writes ``GANTrainer.state_to_jax``
through ``core/checkpoint.py::save_bundle`` with the metadata
``{"converted_from": <checkpoint>}``, the bundle the JAX ``save_model`` writes.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Convert GAN checkpoints to/from torchgan .model format")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="source checkpoint (native msgpack bundle or torch .model)")
    p.add_argument("--out", type=str, required=True,
                   help="destination path; .model torch export unless --to_native")
    p.add_argument("--to_native", action="store_true", default=False,
                   help="convert INTO a native (JAX msgpack) bundle instead")
    p.add_argument("--epoch", type=int, default=0, help="epoch stamp for the torch bundle")
    p.add_argument("--gan_type", type=str, default=None)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.cli.generate import _load_trainer
    from rnagan_tpu_torch.core.checkpoint import save_bundle
    from rnagan_tpu_torch.core.config import load_reference_json
    from rnagan_tpu_torch.core.device import resolve_device

    resolve_device(args.device)
    cfg_json = load_reference_json(args.config)
    trainer, state = _load_trainer(cfg_json, args.checkpoint, None, args)

    if args.to_native:
        save_bundle(args.out, trainer.state_to_jax(state), {"converted_from": args.checkpoint})
        print(f"native bundle written: {args.out}")
    else:
        arch = trainer.cfg.model.arch
        if arch != "dcgan":  # the JAX package's export_torchgan_bundle refuses it so (dcgan_torch.py:79-83)
            raise ValueError(
                f"torchgan .model interop covers the reference's DCGAN family; arch={arch!r} "
                "has no torchgan counterpart (the reference never wires dcgan_up, and condgan "
                "head shapes depend on num_classes)")
        trainer.save_model(state, args.out, epoch=args.epoch)
        print(f"torchgan .model written: {args.out}")
    return args.out


if __name__ == "__main__":
    main()
