"""Downstream classification CLI (port of ``rnagan_tpu/cli/ml_experiment.py``,
the reference ``src/ml_experiments.py``: GBM vs LUAD tiles, 5-fold CV),
``--device`` in place of ``--platform``:

    python -m rnagan_tpu_torch.cli.ml_experiment --csv wsi_tiles_real.csv \\
        [--test_csv held_out.csv] [--backbone_weights resnet50.pt] --save_path experiment.pkl

No pandas: the CSV is read with ``csv``; ``--max_tiles`` keeps
``RandomState(seed).choice(n, k, replace=False)`` rows, the rows pandas'
``df.sample(k, random_state=seed)`` keeps; the labels are
``cli/interpolate.py::factorize``'s codes (``pd.factorize``). Tiles are
read with PIL (imported inside the loader) and resized as the JAX CLI
resizes them. ``--backbone_weights`` is a torchvision ResNet ``state_dict``
(``torch.load(weights_only=True)``), with the JAX package's input-channel
surgery (``models/resnet.py::state_dict_from_torchvision``). Under torchrun
every rank goes on the data axis (``--dist_backend``, NCCL by default); rank 0
writes ``--save_path``.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from rnagan_tpu_torch.cli.common import add_dist_arguments, dump_pickle, training_mesh


def build_parser():
    p = argparse.ArgumentParser(description="GBM vs LUAD tile classification, 5-fold CV")
    p.add_argument("--csv", type=str, required=True,
                   help="CSV of tile paths + labels (wsi_tiles_real.csv format)")
    p.add_argument("--path_column", type=str, default="wsi_file_name")
    p.add_argument("--label_column", type=str, default="label")
    p.add_argument("--test_csv", type=str, default=None, help="held-out test tiles")
    p.add_argument("--num_epochs", type=int, default=40)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--arch", type=str, default="resnet50", help="resnet18|34|50|101|152")
    p.add_argument("--backbone_weights", type=str, default=None,
                   help="torch state_dict (.pt) for the pretrained path "
                        "(ResnetSSL / --use_pretrain, reference ml_experiments.py:286-295)")
    p.add_argument("--max_tiles", type=int, default=None)
    p.add_argument("--save_path", type=str, default="gbmvsluad_experiment_test.pkl")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    add_dist_arguments(p)
    return p


def _classes(cells, codes):
    """``pd.factorize``'s uniques: each code's first cell, as a number where
    the column reads as numbers (an int where it is integral)."""
    from rnagan_tpu_torch.cli.interpolate import _number

    firsts = {}
    for cell, code in zip(cells, codes):
        firsts.setdefault(int(code), cell.strip())
    uniq = [firsts[c] for c in range(len(firsts) - (-1 in firsts))]
    numbers = [_number(c) for c in uniq]
    if uniq and all(x is not None for x in numbers):
        return [int(x) if float(x).is_integer() else x for x in numbers]
    return uniq


def _load_tiles_csv(csv_path, path_col, label_col, image_size, max_tiles, seed):
    from PIL import Image

    from rnagan_tpu_torch.cli.interpolate import factorize

    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if max_tiles:
        rows = [rows[i] for i in np.random.RandomState(seed).choice(len(rows), min(len(rows), max_tiles),
                                                                    replace=False)]
    cells = [r[label_col] for r in rows]
    labels = factorize(cells)
    images = np.zeros((len(rows), image_size, image_size, 3), np.float32)
    for i, r in enumerate(rows):
        img = Image.open(r[path_col]).convert("RGB").resize((image_size, image_size))
        images[i] = np.asarray(img, np.float32) / 255.0
    return images, labels, _classes(cells, labels)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # before anything is read
    mesh = training_mesh(args, MLConfig().mesh)

    import torch

    from rnagan_tpu_torch.models.resnet import ARCHS, state_dict_from_torchvision
    from rnagan_tpu_torch.train.ml_experiment import run_cv_experiment

    images, labels, classes = _load_tiles_csv(args.csv, args.path_column, args.label_column,
                                              args.image_size, args.max_tiles, args.seed)
    print(f"{len(images)} tiles, classes: {classes}")

    test_images = test_labels = None
    if args.test_csv:
        test_images, test_labels, _ = _load_tiles_csv(args.test_csv, args.path_column, args.label_column,
                                                      args.image_size, args.max_tiles, args.seed)

    backbone_variables = None
    if args.backbone_weights:
        layout = ARCHS[args.arch](num_classes=len(classes), device="meta")
        sd = torch.load(args.backbone_weights, map_location="cpu", weights_only=True)
        backbone_variables = state_dict_from_torchvision(layout, sd)

    cfg = MLConfig(num_classes=len(classes), num_epochs=args.num_epochs, folds=args.folds,
                   batch_size=args.batch_size, image_size=args.image_size, lr=args.lr, seed=args.seed,
                   arch=args.arch)
    results = run_cv_experiment(images, labels, cfg, test_images01=test_images, test_labels=test_labels,
                                backbone_variables=backbone_variables, mesh=mesh)
    print(f"mean accuracy {results['mean_accuracy']:.4f} | mean weighted F1 {results['mean_weighted_f1']:.4f}")
    if mesh.writer:
        dump_pickle(args.save_path, {**results, "classes": classes})
    return results
