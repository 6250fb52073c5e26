"""Latent interpolation CLI (port of ``rnagan_tpu/cli/interpolate.py``, the
reference ``src/betaVAE_interpolation.py`` surface, ``--device`` in place of
``--platform``): class-centroid latent difference vectors, tissue against
tissue by default or by any column of a phenotype CSV (GTEx sex), and the
shifted reconstructions, pickled.

    python -m rnagan_tpu_torch.cli.interpolate --config CFG --checkpoint model_dict_best.pt \\
        [--label_column sex --phenotype_csv pheno.csv] --save_path interp.pkl

No pandas: the JAX CLI's frame operations are rebuilt over ``data/rna.py``:

* ``pd.concat`` of the tissue CSVs, each row labelled with its CSV's index;
* the inner ``merge`` on ``wsi_file_name`` with the phenotype CSV: left rows
  in their order, each repeated for every matching phenotype row in that
  file's order, unmatched rows dropped (:func:`merge_labels`);
* ``pd.factorize``: codes in order of first appearance, an empty cell -1;
  a column whose cells all read as numbers is compared as numbers, as pandas
  parses it (:func:`factorize`).

``--checkpoint`` is a betaVAE ``.pt`` or a JAX ``model_best.ckpt``; the
expression is log-transformed and standardized over all rows.
"""

from __future__ import annotations

import argparse
import csv
import math
from typing import List, Sequence, Tuple

import numpy as np

from rnagan_tpu_torch.cli.common import dump_pickle


def build_parser():
    p = argparse.ArgumentParser(description="Latent-space interpolation analysis")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--label_column", type=str, default=None,
                   help="column in --phenotype_csv to group by (default: tissue id per CSV)")
    p.add_argument("--phenotype_csv", type=str, default=None,
                   help="joins on wsi_file_name (the GTEx male/female path, "
                        "reference betaVAE_interpolation.py:156-209)")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--save_path", type=str, default="interpolation.pkl")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda", help="torch device (default: cuda)")
    return p


def _number(cell: str):
    try:
        return float(cell)
    except ValueError:
        return None


def factorize(values: Sequence[str]) -> np.ndarray:
    """``pd.factorize`` of a CSV column read as pandas reads it: codes in order
    of first appearance, -1 for an empty cell."""
    cells = [v.strip() for v in values]
    numbers = [_number(c) for c in cells if c]
    numeric = all(x is not None for x in numbers)
    codes, seen = [], {}
    for c in cells:
        if not c or (numeric and math.isnan(float(c))):
            codes.append(-1)
            continue
        key = float(c) if numeric else c
        codes.append(seen.setdefault(key, len(seen)))
    return np.asarray(codes, np.int64)


def merge_labels(wsi: Sequence[str], pheno_csv: str, column: str) -> Tuple[np.ndarray, List[str]]:
    """The inner merge of rows keyed ``wsi`` with ``pheno_csv``'s
    (``wsi_file_name``, ``column``): ``(row index of each merged row, its
    label cell)``, in pandas' order."""
    with open(pheno_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    matches = {}
    for r in rows:
        matches.setdefault(r["wsi_file_name"], []).append(r[column])
    idx, labels = [], []
    for i, key in enumerate(wsi):
        for cell in matches.get(str(key), ()):
            idx.append(i)
            labels.append(cell)
    return np.asarray(idx, np.intp), labels


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rnagan_tpu_torch.cli.common import load_vae
    from rnagan_tpu_torch.core.config import load_reference_json, vae_config_from_json
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.rna import RNATable, normalize_dfs, rna_matrix
    from rnagan_tpu_torch.eval.interpolate import interpolation_report

    device = resolve_device(args.device)  # before anything is read
    config = load_reference_json(args.config)
    cfg = vae_config_from_json(config)
    model, _, _ = load_vae(args.checkpoint, cfg.model, device)

    tables = [RNATable.read_csv(path) for path in config["path_csv"]]
    table = RNATable.concat(tables)
    labels = np.concatenate([np.full(len(t), i, np.int64) for i, t in enumerate(tables)])

    if args.label_column and args.phenotype_csv:
        if table.wsi_file_name is None:
            raise ValueError("joining a phenotype CSV needs a wsi_file_name column in every CSV")
        idx, cells = merge_labels(table.wsi_file_name, args.phenotype_csv, args.label_column)
        table, labels = table.take(idx), factorize(cells)

    table = normalize_dfs(table)[0]
    report = interpolation_report(model, rna_matrix(table), labels, alpha=args.alpha)
    dump_pickle(args.save_path, report)
    print(f"wrote {args.save_path}: {len(report['difference_vectors'])} difference vectors")
    return report


if __name__ == "__main__":
    main()
