"""Time-series data pipeline for the FL clients, without pandas.

Twin of ``ppqsflhe_tpu.train.data`` (the reference client's pandas feature
engineering, client/src/c_trainAndUpdate.py:104-119): calendar features
from the Timestamp column, a StandardScaler fit on the train split only,
and lookback-window sequences whose channels are [6 scaled features, scaled
target] (prepare_sequences, c_trainAndUpdate.py:36-44). A frame is a
:class:`Frame` of numpy columns with ``datetime64`` timestamps, parsed
with ``csv`` and ``datetime`` the way ``pd.to_datetime(errors="coerce",
dayfirst=...)`` parses them: one format guessed from the first timestamp,
then applied strictly to every row, a row that does not match becoming NaT.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass
from datetime import datetime

import numpy as np

FEATURE_NAMES = ["DayOfYear", "Month", "DayOfWeek", "WeekOfYear", "AcademicMonth", "HourOfDay"]
TARGET = "Data"
TIMESTAMP = "Timestamp"
ACADEMIC_MONTHS = (1, 2, 3, 4, 5, 8, 9, 10, 11)
_NAT = np.datetime64("NaT", "s")


class Frame:
    """Named numpy columns of one length. ``frame["col"]`` is a column,
    ``frame[["a", "b"]]`` the float64 matrix of those columns (pandas'
    ``df[cols].values``)."""

    def __init__(self, columns: dict):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        return np.stack([np.asarray(self.columns[k], np.float64) for k in key], axis=1)

    def rows(self, mask) -> "Frame":
        return Frame({k: v[mask] for k, v in self.columns.items()})


_DATE = re.compile(r"^(\d{1,4})([-/.])(\d{1,2})\2(\d{1,4})(?:([ T])(\d{1,2}):(\d{2})(:\d{2})?)?$")


def guess_format(first: str, dayfirst: bool) -> str:
    """The strptime format pandas infers from the first timestamp: a year
    first or last; day and month ordered by ``dayfirst`` unless the value
    rules that order out (a field above 12 is the day)."""
    m = _DATE.match(first.strip())
    if not m:
        raise ValueError(f"unrecognised timestamp {first!r}")
    a, sep, b, c, tsep, _, _, secs = m.groups()
    if len(a) == 4:
        day_then_month = (dayfirst and int(c) <= 12) or int(b) > 12
        date = f"%Y{sep}%d{sep}%m" if day_then_month else f"%Y{sep}%m{sep}%d"
    elif len(c) == 4:
        day_then_month = (dayfirst and int(b) <= 12) or int(a) > 12
        date = f"%d{sep}%m{sep}%Y" if day_then_month else f"%m{sep}%d{sep}%Y"
    else:
        raise ValueError(f"no four-digit year in timestamp {first!r}")
    if tsep is None:
        return date
    return f"{date}{tsep}%H:%M" + (":%S" if secs else "")


def parse_timestamps(texts, dayfirst: bool) -> np.ndarray:
    """datetime64[s] per text; NaT where a text does not match the format
    guessed from the first non-empty one."""
    first = next((t for t in texts if t), None)
    if first is None:
        return np.full(len(texts), _NAT)
    fmt = guess_format(first, dayfirst)
    out = np.full(len(texts), _NAT)
    for i, t in enumerate(texts):
        try:
            out[i] = np.datetime64(datetime.strptime(t.strip(), fmt), "s")
        except ValueError:
            pass
    return out


def _column(texts) -> np.ndarray:
    try:
        return np.array([float(t) if t != "" else np.nan for t in texts], np.float64)
    except ValueError:
        return np.array(texts, dtype=object)


def calendar_features(ts: np.ndarray) -> dict:
    """The six calendar columns of ``FEATURE_NAMES`` as float64, NaN on NaT
    rows (AcademicMonth 0 there, as pandas' ``apply`` gives)."""
    cols = {k: np.full(len(ts), np.nan) for k in FEATURE_NAMES}
    for i, t in enumerate(ts):
        if np.isnat(t):
            cols["AcademicMonth"][i] = 0.0
            continue
        d = t.astype(datetime)
        cols["DayOfYear"][i] = d.timetuple().tm_yday
        cols["Month"][i] = d.month
        cols["DayOfWeek"][i] = d.weekday()
        cols["WeekOfYear"][i] = d.isocalendar()[1]
        cols["AcademicMonth"][i] = 1.0 if d.month in ACADEMIC_MONTHS else 0.0
        cols["HourOfDay"][i] = d.hour
    return cols


def load_timeseries(csv_path: str, dayfirst: bool = True) -> Frame:
    """``dayfirst=True`` (default) parses the reference datasets' DD-MM-YYYY
    timestamps correctly. ``dayfirst=False`` replicates the reference
    scripts' own month-first pandas default (c_trainAndUpdate.py:96,
    c_evalulate_rounds.py:75): on its day-first CSVs that reading turns
    days 1-12 of July into the 7th of Jan..Dec and coerces days 13+ to NaT
    (dropped by the date-split comparisons) — the committed reference
    metrics were computed on that view, so the parse is bug-compatible."""
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        body = [row + [""] * (len(header) - len(row)) for row in reader if row]
    if TIMESTAMP not in header:
        raise ValueError(f"expected {TIMESTAMP!r} column, got {header}")
    raw = {name: [row[j] for row in body] for j, name in enumerate(header)}
    cols = {name: _column(v) for name, v in raw.items() if name != TIMESTAMP}
    cols[TIMESTAMP] = parse_timestamps(raw[TIMESTAMP], dayfirst)
    cols.update(calendar_features(cols[TIMESTAMP]))
    return Frame(cols)


@dataclass
class Scaler:
    """StandardScaler twin (mean/std per column, ddof=0 like sklearn)."""

    mean: np.ndarray = None
    std: np.ndarray = None

    def fit(self, x: np.ndarray) -> "Scaler":
        self.mean = np.asarray(x, np.float64).mean(axis=0)
        self.std = np.asarray(x, np.float64).std(axis=0)
        self.std = np.where(self.std == 0, 1.0, self.std)
        return self

    def transform(self, x):
        return (np.asarray(x, np.float64) - self.mean) / self.std

    def inverse(self, x):
        return np.asarray(x, np.float64) * self.std + self.mean


def prepare_sequences(df: Frame, lookback: int, fs: Scaler, ts: Scaler):
    """Sliding windows: X[i] = [features||target][i-lookback:i], y[i] = target[i]."""
    features = fs.transform(df[FEATURE_NAMES])
    targets = ts.transform(df[[TARGET]])
    chan = np.concatenate([features, targets], axis=1)
    n = len(df)
    if n <= lookback:
        return np.zeros((0, lookback, chan.shape[1])), np.zeros((0,))
    idx = np.arange(lookback, n)
    seqs = np.stack([chan[i - lookback : i] for i in idx])
    targs = targets[idx, 0]
    return seqs.astype(np.float32), targs.astype(np.float32)


def train_test_frames(df: Frame, train_end: str, test_start: str):
    """Rows up to ``train_end`` and from ``test_start`` (NaT rows in neither)."""
    ts = df[TIMESTAMP]
    end = np.datetime64(datetime.fromisoformat(train_end), "s")
    start = np.datetime64(datetime.fromisoformat(test_start), "s")
    return df.rows(ts <= end), df.rows(ts >= start)


def train_val_split(X, y, val_frac: float = 0.1):
    """Last-10%-as-validation split (c_trainAndUpdate.py:122-123)."""
    nval = int(val_frac * len(X))
    if nval == 0:
        return X, y, X[:0], y[:0]
    return X[:-nval], y[:-nval], X[-nval:], y[-nval:]
