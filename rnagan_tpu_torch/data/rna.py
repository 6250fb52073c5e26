"""RNA-seq data layer without pandas (port of ``rnagan_tpu/data/rna.py``).

The JAX package keeps splits as pandas DataFrames. The port keeps them as an
:class:`RNATable` read with the standard library's ``csv``: the expression
columns (every column whose name holds ``"rna_"``, in file order), their
values as one float64 matrix, and the ``wsi_file_name`` column when the file
has one. Other columns are not kept: nothing downstream reads them.

The functions reproduce the JAX package's, row for row:

* :func:`log_transform`: natural log with zeros mapped to 0;
* :class:`Scaler`: standard (population std) or minmax, fit on train only;
* :func:`split_df`: ``np.random.RandomState(seed).permutation``, the first
  ``round(n * frac)`` rows to the test side;
* :func:`load_tissue_splits`: per tissue 64/16/20, ``quick`` mode first
  keeping ``min(10, n)`` rows as pandas' ``df.sample(k, random_state=seed)``
  picks them (``RandomState(seed).choice(n, k, replace=False)``), then concat
  with integer tissue labels on the test rows;
* :func:`normalize_dfs`, :func:`rna_matrix`, :func:`batch_iterator`.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rnagan_tpu_torch.data.batching import batch_indices

WSI_COLUMN = "wsi_file_name"


def _float(cell: str) -> float:
    return float(cell) if cell.strip() else float("nan")  # an empty cell is NaN, as pandas reads it


@dataclass
class RNATable:
    """One split: ``values`` (rows, genes) float64 under ``columns``, and
    the rows' ``wsi_file_name`` (str array) or None."""

    columns: Tuple[str, ...]
    values: np.ndarray
    wsi_file_name: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.values.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        """(rows, columns), the ``wsi_file_name`` column counted."""
        return len(self), len(self.columns) + (self.wsi_file_name is not None)

    def take(self, idx) -> "RNATable":
        idx = np.asarray(idx, np.intp)
        wsi = None if self.wsi_file_name is None else self.wsi_file_name[idx]
        return RNATable(self.columns, self.values[idx], wsi)

    def with_values(self, values: np.ndarray) -> "RNATable":
        return RNATable(self.columns, np.asarray(values, np.float64), self.wsi_file_name)

    @staticmethod
    def concat(tables: Sequence["RNATable"]) -> "RNATable":
        cols = tables[0].columns
        if any(t.columns != cols for t in tables):
            raise ValueError("tables to concatenate must have the same expression columns")
        wsi = None
        if all(t.wsi_file_name is not None for t in tables):
            wsi = np.concatenate([t.wsi_file_name for t in tables])
        return RNATable(cols, np.concatenate([t.values for t in tables], axis=0), wsi)

    @staticmethod
    def read_csv(path: str) -> "RNATable":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = [row for row in reader if row]
        cols = [i for i, name in enumerate(header) if "rna_" in name]
        values = np.array([[_float(row[i]) for i in cols] for row in rows], np.float64)
        values = values.reshape(len(rows), len(cols))
        wsi = None
        if WSI_COLUMN in header:
            j = header.index(WSI_COLUMN)
            wsi = np.array([row[j] for row in rows], dtype=object)
        return RNATable(tuple(header[i] for i in cols), values, wsi)


def log_transform(values: np.ndarray) -> np.ndarray:
    """Natural log with zeros mapped to 0 (reference ``read_data.py:468-471``)."""
    values = np.asarray(values, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(values > 0, np.log(np.where(values > 0, values, 1.0)), 0.0)
    return out


@dataclass
class Scaler:
    """Checkpointable feature scaler: ``transform(x) = (x - offset) / scale``
    (sklearn's Standard/MinMaxScaler, reference ``read_data.py:488-495``)."""

    kind: str
    offset: np.ndarray
    scale: np.ndarray

    _KINDS = ("standard", "minmax")

    @staticmethod
    def fit(values: np.ndarray, kind: str = "standard") -> "Scaler":
        values = np.asarray(values, np.float64)
        if kind == "standard":
            offset = values.mean(axis=0)
            scale = values.std(axis=0)  # population std (ddof 0), as sklearn
            scale = np.where(scale == 0.0, 1.0, scale)
        elif kind == "minmax":
            lo = values.min(axis=0)
            hi = values.max(axis=0)
            offset, scale = lo, np.where(hi - lo == 0.0, 1.0, hi - lo)
        else:
            raise ValueError(f"unknown scaler kind: {kind}")
        return Scaler(kind, offset.astype(np.float64), scale.astype(np.float64))

    def transform(self, values: np.ndarray) -> np.ndarray:
        return ((np.asarray(values, np.float64) - self.offset) / self.scale).astype(np.float32)

    def inverse_transform(self, values: np.ndarray) -> np.ndarray:
        return (np.asarray(values, np.float64) * self.scale + self.offset).astype(np.float32)

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The JAX package's form: the kind as an int (``kind_id``), offset, scale."""
        return {"kind_id": np.int32(self._KINDS.index(self.kind)), "offset": self.offset,
                "scale": self.scale}

    @staticmethod
    def from_state_dict(d) -> "Scaler":
        return Scaler(Scaler._KINDS[int(d["kind_id"])], np.asarray(d["offset"]), np.asarray(d["scale"]))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, **self.state_dict())

    @staticmethod
    def load(path: str) -> "Scaler":
        with np.load(path) as d:
            return Scaler.from_state_dict(d)


def normalize_dfs(
    train: RNATable,
    val: Optional[RNATable] = None,
    test: Optional[RNATable] = None,
    norm_type: str = "standard",
) -> Tuple[RNATable, Optional[RNATable], Optional[RNATable], Scaler]:
    """log -> scaler fit on train -> every split transformed (reference
    ``read_data.py:467-497``); the tables' float64 values hold the float32 result."""
    train_vals = log_transform(train.values)
    scaler = Scaler.fit(train_vals, norm_type)

    def _apply(t):
        return None if t is None else t.with_values(scaler.transform(log_transform(t.values)))

    return train.with_values(scaler.transform(train_vals)), _apply(val), _apply(test), scaler


def split_df(table: RNATable, test_frac: float, seed: int) -> Tuple[RNATable, RNATable]:
    """Deterministic row split, ``(train, test)``."""
    idx = np.random.RandomState(seed).permutation(len(table))
    n_test = int(round(len(table) * test_frac))
    return table.take(idx[n_test:]), table.take(idx[:n_test])


def sample_rows(table: RNATable, k: int, seed: int) -> RNATable:
    """``k`` rows without replacement, as pandas' ``df.sample(k, random_state=seed)``."""
    return table.take(np.random.RandomState(seed).choice(len(table), k, replace=False))


def load_tissue_splits(
    csv_paths: Sequence[str], seed: int = 99, quick: bool = False
) -> Tuple[RNATable, RNATable, RNATable, np.ndarray]:
    """Per-tissue 64/16/20 split then concat, with integer tissue labels on the
    test rows (reference ``betaVAE_training.py:60-96``). Returns
    ``(train, val, test, test_labels)``."""
    parts: Dict[str, List[RNATable]] = {"train": [], "val": [], "test": []}
    test_labels: List[int] = []
    for tissue_id, path in enumerate(csv_paths):
        table = RNATable.read_csv(path)
        if quick:
            table = sample_rows(table, min(10, len(table)), seed)
        train, test = split_df(table, 0.2, seed + tissue_id)
        train, val = split_df(train, 0.2, seed + tissue_id + 1000)
        parts["train"].append(train)
        parts["val"].append(val)
        parts["test"].append(test)
        test_labels += [tissue_id] * len(test)
    return (RNATable.concat(parts["train"]), RNATable.concat(parts["val"]),
            RNATable.concat(parts["test"]), np.asarray(test_labels, np.int32))


def rna_matrix(table: RNATable) -> np.ndarray:
    """A split as one contiguous float32 matrix (rows x genes)."""
    return np.ascontiguousarray(table.values, dtype=np.float32)


def batch_iterator(
    data: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = False,
    pad_to: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(batch, valid_mask)`` (semantics of ``data/batching.py``)."""
    for idx, mask in batch_indices(len(data), batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                                   pad_to=pad_to, drop_remainder=drop_remainder):
        yield data[idx], mask
