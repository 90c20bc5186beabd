"""ctypes bindings for the host-side runtime in ``src/batcher.cc``.

The port's copy of ``deepctr_tpu/native``: the flat-matrix assembly
(``assemble``), row takes (``take_rows``), 64-bit FNV-1a feature hashing
(``hash_to_bucket``, for ``SparseFeat(use_hash=True)``) and the Criteo
line parser (``parse_criteo``, behind ``data.criteo_stream``).  The C++
source is the JAX package's, unchanged.

``g++`` builds the library at first use into ``deepctr_tpu_torch/_build/``
(``libbatcher-<hash>.so``, named by the hash of its source and flags),
writing a temporary file and renaming it, so that processes that load it
at once never read a half-written one.  A failed build raises: the port
takes no silent numpy path.  The numpy versions stay as the plain
versions (``assemble_ref``, ``take_rows_ref``, ``hash_to_bucket_ref``,
``parse_criteo_ref``), which the tests hold the library against.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "batcher.cc"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the built library lies: named by the hash of its source and
    flags, so that an edited source is never served by an old build."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ("libbatcher-%s.so" % digest)


def _build(path):
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name("%s.%d.%d.tmp" % (path.name, os.getpid(),
                                           threading.get_ident()))
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("the native batcher needs g++ to build %s: %s"
                           % (SRC, e)) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed to build the native batcher:\n%s"
                           % (proc.stdout + proc.stderr))
    os.replace(tmp, path)   # atomic: another process may load it


def load():
    """The loaded library, built first if needed; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dctr_assemble.argtypes = [
            f32p, ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int64]
        lib.dctr_assemble.restype = None
        lib.dctr_take_rows.argtypes = [f32p, f32p, i64p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.dctr_take_rows.restype = None
        lib.dctr_hash_strings.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i64p, ctypes.c_int64,
            ctypes.c_int64, i64p]
        lib.dctr_hash_strings.restype = None
        lib.dctr_hash_i64.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                      i64p]
        lib.dctr_hash_i64.restype = None
        lib.dctr_parse_criteo.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, i64p, ctypes.c_char, ctypes.c_int, f32p, f32p,
            f32p, i64p]
        lib.dctr_parse_criteo.restype = ctypes.c_int64
        _lib = lib
        return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as_columns(arrays):
    """Contiguous float32 2-D arrays of one row count (the library reads
    that many rows from every array), else ValueError."""
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    rows = arrays[0].shape[0]
    bad = [i for i, a in enumerate(arrays) if a.shape[0] != rows]
    if bad:
        raise ValueError(
            "assemble: all arrays must have the same number of rows; "
            "array 0 has %d but array %d has %d"
            % (rows, bad[0], arrays[bad[0]].shape[0]))
    return arrays


def assemble_ref(arrays):
    """Plain version of :func:`assemble`: ``np.concatenate``."""
    return np.concatenate(_as_columns(arrays), axis=1)


def assemble(arrays):
    """Column-concat a list of 2-D float32 arrays -> [rows, total] f32."""
    arrays = _as_columns(arrays)
    lib = load()
    widths = np.array([a.shape[1] for a in arrays], dtype=np.int32)
    rows = arrays[0].shape[0]
    out = np.empty((rows, int(widths.sum())), np.float32)
    srcs = (ctypes.POINTER(ctypes.c_float) * len(arrays))(
        *[_ptr(a, ctypes.c_float) for a in arrays])
    lib.dctr_assemble(_ptr(out, ctypes.c_float), srcs,
                      _ptr(widths, ctypes.c_int), len(arrays), rows)
    return out


def take_rows_ref(matrix, idx):
    """Plain version of :func:`take_rows`: numpy indexing."""
    return np.ascontiguousarray(matrix, dtype=np.float32)[
        np.asarray(idx, dtype=np.int64)]


def take_rows(matrix, idx):
    """matrix[idx] for a 2-D float32 matrix and int64 indices."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= matrix.shape[0]):
        raise IndexError("take_rows: an index lies outside the matrix's "
                         "%d rows" % matrix.shape[0])
    lib = load()
    out = np.empty((len(idx), matrix.shape[1]), np.float32)
    lib.dctr_take_rows(_ptr(out, ctypes.c_float), _ptr(matrix, ctypes.c_float),
                       _ptr(idx, ctypes.c_int64), len(idx), matrix.shape[1])
    return out


def _fnv1a(data):
    h = 1469598103934665603
    for b in data:
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def _encode(values):
    return [v if isinstance(v, bytes) else str(v).encode("utf-8")
            for v in values]


def hash_to_bucket_ref(values, vocabulary_size):
    """Plain version of :func:`hash_to_bucket`: FNV-1a in Python."""
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.integer):
        vals = values.reshape(-1).astype(np.int64)
        out = [_fnv1a(np.int64(v).tobytes()) % vocabulary_size for v in vals]
    else:
        out = [_fnv1a(e) % vocabulary_size
               for e in _encode(values.reshape(-1))]
    return np.array(out, np.int64).reshape(values.shape)


def hash_to_bucket(values, vocabulary_size):
    """Feature hashing onto [0, vocabulary_size): SparseFeat(use_hash=True).

    Accepts an integer array (hashed by its 8 little-endian int64 bytes)
    or an array/list of str/bytes (hashed by their UTF-8 bytes); 64-bit
    FNV-1a, so ids are stable across builds and match the JAX package's.
    """
    values = np.asarray(values)
    lib = load()
    if np.issubdtype(values.dtype, np.integer):
        vals = np.ascontiguousarray(values.reshape(-1), dtype=np.int64)
        out = np.empty(vals.shape, np.int64)
        lib.dctr_hash_i64(_ptr(vals, ctypes.c_int64), vals.size,
                          vocabulary_size, _ptr(out, ctypes.c_int64))
        return out.reshape(values.shape)
    enc = _encode(values.reshape(-1))
    out = np.empty(len(enc), np.int64)
    arr = (ctypes.c_char_p * len(enc))(*enc)
    lens = np.array([len(e) for e in enc], np.int64)
    lib.dctr_hash_strings(arr, _ptr(lens, ctypes.c_int64), len(enc),
                          vocabulary_size, _ptr(out, ctypes.c_int64))
    return out.reshape(values.shape)


def _parse_outputs(buf, n_dense, n_sparse, vocabs, max_rows):
    if max_rows is None:
        max_rows = buf.count(b"\n")
    vocabs = np.ascontiguousarray(
        np.broadcast_to(np.asarray(vocabs, np.int64), (n_sparse,)))
    # zeros: a short line leaves its missing fields at 0
    y = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, max(n_dense, 1)), np.float32)
    sparse = np.zeros((max_rows, max(n_sparse, 1)), np.float32)
    return max_rows, vocabs, y, dense, sparse


def parse_criteo(buf, n_dense, n_sparse, vocabs, sep=",", log_dense=True,
                 max_rows=None):
    """Parse a bytes buffer of Criteo-format lines (label, I*, C*).

    Returns ``(y [n] f32, dense [n, n_dense] f32, sparse [n, n_sparse]
    f32 hashed ids, consumed_bytes)``; only complete lines are consumed,
    so callers stream a file in arbitrary read sizes and carry the tail.
    Categorical fields are FNV-1a-hashed onto [0, vocabs[i]) (empty ->
    0); dense fields get log1p(max(v, 0)) when ``log_dense``.
    """
    lib = load()
    max_rows, vocabs, y, dense, sparse = _parse_outputs(
        buf, n_dense, n_sparse, vocabs, max_rows)
    consumed = ctypes.c_int64(0)
    rows = lib.dctr_parse_criteo(
        buf, len(buf), max_rows, n_dense, n_sparse,
        _ptr(vocabs, ctypes.c_int64),
        sep.encode()[0] if isinstance(sep, str) else sep,
        1 if log_dense else 0, _ptr(y, ctypes.c_float),
        _ptr(dense, ctypes.c_float), _ptr(sparse, ctypes.c_float),
        ctypes.byref(consumed))
    return (y[:rows], dense[:rows, :n_dense], sparse[:rows, :n_sparse],
            consumed.value)


def parse_criteo_ref(buf, n_dense, n_sparse, vocabs, sep=",",
                     log_dense=True, max_rows=None):
    """Plain version of :func:`parse_criteo`, line by line in Python."""
    max_rows, vocabs, y, dense, sparse = _parse_outputs(
        buf, n_dense, n_sparse, vocabs, max_rows)
    sep_b = (sep if isinstance(sep, str) else sep.decode()).encode()
    consumed = 0
    rows = 0
    for line in buf.splitlines(keepends=True):
        if not line.endswith(b"\n") or rows >= max_rows:
            break
        consumed += len(line)
        text = line.rstrip(b"\r\n")
        if not text:
            continue
        parts = text.split(sep_b)
        y[rows] = 1.0 if parts[0] == b"1" else 0.0
        for i in range(n_dense):
            f = parts[1 + i] if 1 + i < len(parts) else b""
            v = float(f) if f else 0.0
            dense[rows, i] = np.log1p(max(v, 0.0)) if log_dense else v
        for i in range(n_sparse):
            j = 1 + n_dense + i
            f = parts[j] if j < len(parts) else b""
            sparse[rows, i] = (_fnv1a(f) % int(vocabs[i])) if f else 0
        rows += 1
    return (y[:rows], dense[:rows, :n_dense], sparse[:rows, :n_sparse],
            consumed)
