"""Data-split readers (counterpart of vlsa_tpu/data/splits.py), with the
`csv` module in place of pandas.  Split ids stay the strings of the file."""
from __future__ import annotations

import csv
import os.path as osp

import numpy as np


def infer_columns_for_splitting(available_columns):
    """(train, test, validation) columns by keyword: the last column whose
    name holds "train", "test", "val"; with no test column the validation
    column is the test split."""
    ret = []
    for key in ("train", "test", "val"):
        target = None
        for c in available_columns:
            if key in c:
                target = c
        ret.append(target)
    train_col, test_col, val_col = ret
    if test_col is None:
        test_col, val_col = val_col, None
    if train_col is None:
        raise ValueError("The column corresponding to `train` is not found.")
    if test_col is None:
        raise ValueError("The column corresponding to `test` is not found.")
    return train_col, test_col, val_col


def read_file_data_splitting(path: str) -> dict:
    """A .csv or .npz split file -> {'train': [...], 'test': [...]} plus
    'validation' where the file has one; empty cells are skipped."""
    ext = osp.splitext(path)[1]
    if ext == ".npz":
        data = np.load(path)
        columns = {c: [str(s) for s in data[c]] for c in data.keys()}
    elif ext == ".csv":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = list(reader)
        columns = {c: [r[i] for r in rows if i < len(r) and r[i] != ""]
                   for i, c in enumerate(header)}
    else:
        raise ValueError(f"unsupported split file extension {ext}")
    train_col, test_col, val_col = infer_columns_for_splitting(list(columns))
    data_split = {"train": columns[train_col], "test": columns[test_col]}
    if val_col is not None:
        data_split["validation"] = columns[val_col]
    return data_split
