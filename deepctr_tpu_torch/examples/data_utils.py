"""Load and prepare the sample datasets of the example recipes with the
``csv`` module and numpy (counterpart of ``examples/data_utils.py``, which
uses pandas and sklearn).

A table is a dict of numpy columns.  A column's type is inferred as pandas'
``read_csv`` infers it: int64 where every field is an integer, float64
where every field is a number or empty (empty fields NaN), else an object
array of strings (empty fields None).  ``label_encode``, ``min_max_scale``
and ``train_test_split`` compute what sklearn's ``LabelEncoder``,
``MinMaxScaler`` and ``train_test_split`` do, to the bit.  The samples
(``criteo_sample.txt``, ``movielens_sample.txt``, ``byterec_sample.txt``)
are read from the repository's ``examples/data/``.
"""

import csv
import os

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "data")

BYTEREC_NAMES = ["uid", "user_city", "item_id", "author_id", "item_city",
                 "channel", "finish", "like", "music_id", "device", "time",
                 "duration_time"]


def sample_path(name):
    path = os.path.join(DATA_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError("sample dataset %s not found" % path)
    return path


def _column(fields):
    """pandas' type inference on one column's fields."""
    try:
        return np.array([int(f) for f in fields], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(f) if f != "" else np.nan for f in fields],
                        dtype=np.float64)
    except ValueError:
        return np.array([f if f != "" else None for f in fields],
                        dtype=object)


def read_csv(path, sep=",", names=None):
    """``{column: numpy array}`` of a delimited file, its first row the
    header unless ``names`` are given."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    if names is None:
        names, rows = rows[0], rows[1:]
    return {name: _column([r[i] for r in rows])
            for i, name in enumerate(names)}


def load_criteo_sample():
    """label, I1..I13, C1..C26."""
    return read_csv(sample_path("criteo_sample.txt"))


def load_movielens_sample():
    return read_csv(sample_path("movielens_sample.txt"))


def load_byterec_sample():
    """byterec: short-video CTR with two binary targets (finish, like)."""
    return read_csv(sample_path("byterec_sample.txt"), sep="\t",
                    names=BYTEREC_NAMES)


def fillna(column, value):
    """``column`` with its missing fields (NaN, None) set to ``value``."""
    if column.dtype == object:
        return np.array([value if v is None else v for v in column],
                        dtype=object)
    if column.dtype.kind == "f":
        return np.where(np.isnan(column), value, column)
    return column


def label_encode(column):
    """sklearn's ``LabelEncoder().fit_transform``: each value's index
    among the sorted distinct values."""
    return np.unique(column, return_inverse=True)[1].reshape(-1)


def min_max_scale(columns):
    """sklearn's ``MinMaxScaler((0, 1)).fit_transform`` of each column (a
    constant column scales by 1), in its arithmetic: ``x * scale +
    (0 - min * scale)`` with ``scale = 1 / (max - min)``."""
    out = []
    for c in columns:
        c = np.asarray(c, dtype=np.float64)
        lo, hi = np.nanmin(c), np.nanmax(c)
        span = hi - lo
        scale = 1.0 / (span if span != 0.0 else 1.0)
        out.append(c * scale + (0.0 - lo * scale))
    return out


def train_test_split(n, test_size=0.2, random_state=None):
    """``(train rows, test rows)`` as sklearn's ``train_test_split`` draws
    them: a ``RandomState(random_state)`` permutation, the test rows
    first (``ceil(test_size * n)`` of them)."""
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:], perm[:n_test]


def take(table, rows):
    """The rows ``rows`` (indices or a slice) of every column."""
    return {k: v[rows] for k, v in table.items()}


def pad_post(seqs, maxlen):
    """Sequences of ids as an int64 [n, maxlen] matrix, zero-padded at the
    end."""
    out = np.zeros((len(seqs), maxlen), dtype=np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s[:maxlen]
    return out
