"""Out-of-core data pipelines: a Criteo-format file as ``fit``'s chunk
iterator.

The port's copy of ``deepctr_tpu/data.py``.  ``criteo_stream`` turns a
Criteo-format file of any size into the zero-argument callable that
``BaseModel.fit`` accepts (``fit(x=criteo_stream(...), ...)``); parsing
and feature hashing run in the native C++ reader
(``native/src/batcher.cc:dctr_parse_criteo``).
"""

from . import native
from .features import DenseFeat, SparseFeat


def criteo_columns(vocab_size=1_000_000, embedding_dim=16,
                   n_dense=13, n_sparse=26):
    """Feature columns for the standard Criteo display-ads layout:
    ``C1..C{n_sparse}`` hashed onto ``vocab_size`` buckets plus
    ``I1..I{n_dense}`` log-transformed dense fields."""
    return ([SparseFeat("C%d" % (i + 1), vocab_size, embedding_dim)
             for i in range(n_sparse)]
            + [DenseFeat("I%d" % (i + 1), 1) for i in range(n_dense)])


def criteo_stream(path, feature_columns, chunk_rows=262144, sep=None,
                  log_dense=True, read_bytes=1 << 24):
    """Stream a Criteo-format file as ``fit``-ready chunks.

    Returns a zero-argument callable; each call re-opens ``path`` and
    yields ``(x_dict, y)`` chunks of up to ``chunk_rows`` rows, where
    ``x_dict`` maps the sparse and dense names in ``feature_columns`` to
    hashed id and log1p-transformed columns.  Pass the callable straight
    to ``model.fit(x=..., batch_size=...)`` (``BaseModel._fit_stream``).

    ``sep=None`` sniffs the first line: '\\t' when it holds a tab and no
    comma, ',' otherwise.  Pass ``sep`` for files the sniff could misread
    (a TSV whose first row has commas inside its values).  A leading
    ``label,...`` header row is skipped.  The file is read ``read_bytes``
    at a time and every full chunk the buffer holds is drained before the
    next read, so memory stays at about ``read_bytes`` whatever
    ``chunk_rows``; a last line without a newline is still read.
    """
    sparse_names = [f.name for f in feature_columns
                    if isinstance(f, SparseFeat)]
    dense_names = [f.name for f in feature_columns
                   if isinstance(f, DenseFeat)]
    vocabs = [f.vocabulary_size for f in feature_columns
              if isinstance(f, SparseFeat)]
    n_sparse, n_dense = len(sparse_names), len(dense_names)

    if sep is None:
        with open(path, "rb") as fh:
            first = fh.readline()
        sep = "\t" if (b"\t" in first and b"," not in first) else ","

    def gen():
        with open(path, "rb") as fh:
            first = fh.readline()
            if not first.lower().startswith(b"label"):
                fh.seek(0)
            buf = b""
            eof = False
            while True:
                if not eof:
                    block = fh.read(read_bytes)
                    if block:
                        buf += block
                    else:
                        eof = True
                        if buf and not buf.endswith(b"\n"):
                            buf += b"\n"   # the last, unterminated line
                while True:
                    y, dense, sparse, consumed = native.parse_criteo(
                        buf, n_dense, n_sparse, vocabs, sep=sep,
                        log_dense=log_dense, max_rows=chunk_rows)
                    buf = buf[consumed:]
                    if len(y):
                        x = {name: sparse[:, i]
                             for i, name in enumerate(sparse_names)}
                        x.update({name: dense[:, i]
                                  for i, name in enumerate(dense_names)})
                        yield x, y
                    if len(y) < chunk_rows:
                        break
                if eof:
                    break

    return gen
