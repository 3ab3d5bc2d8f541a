"""Patient-level survival labels and discrete time bins (counterpart of
vlsa_tpu/data/label_converter.py), with `csv` and numpy in place of pandas.

Labels are discrete time bins or continuous times.  Bins are inferred from
the training split: uniform intervals or quantiles of the event times, by
default ceil(sqrt(#events)) of them; the first edge is 0 and the last the
cohort's largest time plus 1e-5.  Continuous labels are the times
(`continuous_time`) or the times over the training split's largest, clipped
at 1 (`continuous_ratio`).  The few-shot sampler bins each patient by a
Kaplan-Meier best guess of the censored times (`calculate_uncensored_time_bins`).
"""
from __future__ import annotations

import csv
import math
from typing import Dict, List, Optional

import numpy as np

from ..eval.km import KaplanMeierArea

EPS = 1e-5


def get_best_guess_from_training_data(train_t, train_e) -> np.ndarray:
    """The cohort's times with each censored time replaced by its
    Kaplan-Meier best guess (the residual mean survival time of the KM margin
    method); censored times past the KM curve's linear zero stay as they are."""
    train_t = np.asarray(train_t)
    train_e = np.asarray(train_e).astype(bool)
    km_model = KaplanMeierArea(train_t, train_e)
    km_linear_zero = km_model.km_linear_zero
    if np.isinf(km_linear_zero):
        km_linear_zero = max(km_model.survival_times)
    best = train_t.copy().astype(float)
    censor_times = train_t[~train_e]
    if censor_times.size:
        guess = km_model.best_guess(censor_times.astype(float))
        beyond = censor_times > km_linear_zero
        guess[beyond] = censor_times[beyond]
        best[~train_e] = guess
    return best


def calculate_discrete_time_bins(t: np.ndarray, e: np.ndarray,
                                 num_bins: Optional[int] = None,
                                 use_quantiles: bool = False,
                                 max_time: Optional[float] = None) -> np.ndarray:
    """Bin edges from the event times t[e == 1]: linear-interpolation
    quantiles (pandas' qcut edges) or a uniform grid up to the last event."""
    event_times = np.asarray(t, np.float64)[np.asarray(e) == 1]
    if num_bins is None:
        num_bins = math.ceil(math.sqrt(len(event_times)))
    if use_quantiles:
        qbins = np.quantile(event_times, np.linspace(0.0, 1.0, num_bins + 1))
        if len(np.unique(qbins)) != len(qbins):
            raise ValueError(f"quantile bin edges are not unique: {qbins}")
    else:
        qbins = np.linspace(0, event_times.max(), num_bins + 1)
    if max_time is None:
        max_time = float(np.max(t))
    qbins[0] = 0
    qbins[-1] = max_time + 1e-5
    return qbins


def cut(values: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Bin ids of `values` for left-closed bins [bins[i], bins[i+1])."""
    ids = np.searchsorted(bins, values, side="right") - 1
    if np.any(ids < 0) or np.any(ids >= len(bins) - 1):
        raise ValueError(f"times outside the bins [{bins[0]}, {bins[-1]})")
    return ids


def calculate_uncensored_time_bins(patient_ids, meta_data: "MetaSurvData"):
    """The bin of each patient's de-censored time (the few-shot sampler's
    strata): the KM best guess, clipped EPS inside the label's bins (or, for
    continuous labels, uniform bins of these patients' event times), then
    binned."""
    actual = meta_data.get_patient_data(patient_ids, ret_columns=["t", "e"])
    uncensored_t = get_best_guess_from_training_data(actual["t"], actual["e"])
    if meta_data.label_format is not None and "discrete" in meta_data.label_format:
        time_bins = meta_data.time_bins
    else:
        time_bins = calculate_discrete_time_bins(actual["t"], actual["e"], num_bins=None,
                                                 use_quantiles=False, max_time=meta_data.max_t)
    uncensored_t = np.clip(uncensored_t, time_bins[0] + EPS, time_bins[-1] - EPS)
    return cut(uncensored_t, np.asarray(time_bins))


class MetaSurvData:
    """The label table (`pathology_id, patient_id, e, t`, one row per slide)
    and its first row per patient."""

    def __init__(self, path_label: str, column_t: str = "t", column_e: str = "e",
                 data_split: Optional[Dict[str, List[str]]] = None):
        self.column_t = column_t
        self.column_e = column_e
        with open(path_label, newline="") as f:
            rows = list(csv.DictReader(f))
        self.slide_ids = [r["pathology_id"] for r in rows]
        self.slide_pids = [r["patient_id"] for r in rows]
        # first row per patient, patients in sorted order (a pandas groupby)
        first: Dict[str, dict] = {}
        for r in rows:
            first.setdefault(r["patient_id"], r)
        self.pids = sorted(first)
        self.t = np.array([float(first[p][column_t]) for p in self.pids])
        self.e = np.array([int(float(first[p][column_e])) for p in self.pids])
        self._row = {p: i for i, p in enumerate(self.pids)}
        self.data_split = data_split
        self.max_t = float(self.t.max())
        self.time_bins: Optional[np.ndarray] = None
        self.label_format: Optional[str] = None
        self.y_t: Optional[np.ndarray] = None

    @property
    def num_bins(self) -> Optional[int]:
        return None if self.time_bins is None else len(self.time_bins) - 1

    @property
    def time_coordinates(self) -> Optional[np.ndarray]:
        """The bins' left edges: the time grid of the predicted curves."""
        return None if self.time_bins is None else self.time_bins[:-1]

    def get_patient_data(self, pids=None, split=None, ret_columns=None) -> Dict[str, np.ndarray]:
        """{column: values} of the first row of each patient of `pids` (or of
        the split `split`; all patients when neither is given), in that
        order; patients the table lacks are skipped.  Columns: patient_id,
        t, e and, once labels are made, y_t and y_e."""
        if pids is None and split is not None:
            assert split in self.data_split, f"split ({split}) not in data_split."
            pids = self.data_split[split]
        rows = np.arange(len(self.pids)) if pids is None else self.patient_rows(pids)
        columns = {"patient_id": np.array(self.pids, dtype=object), "t": self.t, "e": self.e}
        if self.y_t is not None:
            columns.update(y_t=self.y_t, y_e=self.e)
        return {c: columns[c][rows] for c in (ret_columns or columns)}

    def patient_rows(self, pids) -> np.ndarray:
        """Row indices of the patients of `pids` that the table holds."""
        return np.array([self._row[p] for p in pids if p in self._row], np.int64)

    def generate_discrete_label(self, num_bins: Optional[int] = None,
                                use_quantiles: bool = True) -> np.ndarray:
        """Discrete time labels y_t of every patient, with bins inferred from
        the training split where there is one."""
        self.label_format = "discrete_quantile" if use_quantiles else "discrete_uniform"
        rows = (self.patient_rows(self.data_split["train"]) if self.data_split is not None
                else np.arange(len(self.pids)))
        self.time_bins = calculate_discrete_time_bins(
            self.t[rows], self.e[rows], num_bins=num_bins, use_quantiles=use_quantiles,
            max_time=self.max_t)
        self.y_t = cut(self.t, self.time_bins)
        return self.y_t

    def generate_continuous_label(self, normalize: bool = False) -> np.ndarray:
        """Continuous time labels y_t of every patient: the times, or with
        `normalize` each time over the training split's largest (the
        cohort's without a split), clipped at 1."""
        if normalize:
            max_time = (self.t[self.patient_rows(self.data_split["train"])].max()
                        if self.data_split is not None else self.max_t)
            self.y_t = np.minimum(1.0, self.t / max_time)
            self.label_format = "continuous_ratio"
        else:
            self.y_t = self.t.copy()
            self.label_format = "continuous_time"
        return self.y_t

    def collect_info_by_pids(self, pids):
        """(patient ids found, pid -> slide ids, pid -> [y_t, e]); y_t is a
        bin index (int) for discrete labels, a time or ratio (float) for
        continuous ones."""
        if self.y_t is None:
            raise ValueError("generate_discrete_label or generate_continuous_label first")
        discrete = "discrete" in self.label_format
        sel_pids, pid2sids, pid2label = [], {}, {}
        for pid in pids:
            sids = [s for s, p in zip(self.slide_ids, self.slide_pids) if p == pid]
            if not sids:
                print(f"[label converter] warning: patient {pid} not found.")
                continue
            sel_pids.append(pid)
            pid2sids[pid] = sids
            row = self._row[pid]
            y_t = self.y_t[row]
            pid2label[pid] = [int(y_t) if discrete else float(y_t), int(self.e[row])]
        return sel_pids, pid2sids, pid2label
