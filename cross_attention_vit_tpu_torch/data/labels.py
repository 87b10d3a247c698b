"""Label ingest and hygiene for the UCSF-PDGM cohort, with no pandas.

Port of ``cross_attention_vit_tpu/data/labels.py``, which reproduces the
reference's ``clean_data`` (dataset_ucsf.py:160-168):

  1. drop rows whose ID contains any blacklisted substring
     ('138','181','175','278','289','315'), matched before zero-padding;
  2. zero-pad the numeric suffix of the dash-separated ID to 4 digits so IDs
     match the on-disk folder names (UCSF-PDGM-0085);
  3. drop rows whose target is 'indeterminate' or empty;
  4. binarize: target == 'positive' → 1.0 else 0.0 (float).

A labels CSV is read with the ``csv`` module into a ``Table``: named columns
of equal length, every cell a string, a missing one ''.  The splits reproduce
``sklearn.model_selection.train_test_split(..., random_state=seed)`` and
``StratifiedKFold(shuffle=True, random_state=seed)`` with numpy's
``RandomState``, so rows come out in the same order as in the JAX package —
the weighted sampler's weights and the loader follow row order.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

BLACKLIST = ("138", "181", "175", "278", "289", "315")
# the cells pandas.read_csv reads as NaN by default; they load as ''
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})


class Table:
    """Named columns of one length (numpy arrays), in file order."""

    def __init__(self, columns: dict[str, np.ndarray]):
        self.columns = {name: np.asarray(col) for name, col in columns.items()}
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __setitem__(self, name: str, col) -> None:
        self.columns[name] = np.asarray(col)

    def take(self, rows) -> "Table":
        """The rows at ``rows`` (indices or a boolean mask), in that order."""
        return Table({name: col[rows] for name, col in self.columns.items()})


def load_labels(csv_path: str | Path) -> Table:
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r + [""] * (len(header) - len(r)) for r in reader if r]
    return Table({name: np.array(["" if r[i] in _NA else r[i] for r in rows], dtype=object)
                  for i, name in enumerate(header)})


def _pad_id(case_id: str) -> str:
    *head, tail = case_id.split("-")
    return "-".join([*head, tail.zfill(4)])


def clean_data(data: Table, target: str) -> Table:
    ids = data["ID"]
    keep = np.array([not any(b in i for b in BLACKLIST) for i in ids], dtype=bool)
    data = data.take(keep)
    data["ID"] = np.array([_pad_id(i) for i in data["ID"]], dtype=object)
    y = data[target]
    data = data.take(np.array([v not in ("indeterminate", "") for v in y], dtype=bool))
    data[target] = (data[target] == "positive").astype(np.float64)
    return data


def train_test_split(data: Table, test_size: float, seed: int) -> tuple[Table, Table]:
    """(rest, test) as ``train_test_split(data, test_size=...,
    random_state=seed)``: ceil(test_size·n) test rows first in one
    ``RandomState(seed).permutation(n)``, the rest after them."""
    n_test = math.ceil(test_size * len(data))
    perm = np.random.RandomState(seed).permutation(len(data))
    return data.take(perm[n_test:]), data.take(perm[:n_test])


def train_val_test_split(data: Table, test_size: float, val_size: float, seed: int):
    """The live driver's split scheme: 15% test then 18% val off the remainder
    (≈15% of the total), same seed for both (main_mist.py:167, 182)."""
    rest, test_df = train_test_split(data, test_size, seed)
    train_df, val_df = train_test_split(rest, val_size, seed)
    return train_df, val_df, test_df


def stratified_kfold(y: Sequence, n_splits: int, seed: int
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(train, test) row indices of ``StratifiedKFold(n_splits, shuffle=True,
    random_state=seed).split(X, y)``: classes numbered by first appearance;
    each fold's share of a class allotted round robin over the sorted labels;
    each class's fold numbers shuffled by one ``RandomState(seed)``, class by
    class."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y)
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    encoded = class_perm[inverse.reshape(-1)]
    n_classes = len(first)
    if np.all(n_splits > np.bincount(encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class")
    order = np.sort(encoded)
    allocation = np.asarray([np.bincount(order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(for_class)
        folds[encoded == k] = for_class
    rows = np.arange(len(y))
    for i in range(n_splits):
        yield rows[folds != i], rows[folds == i]
