"""The port's Criteo reader (``native.parse_criteo``) and stream
(``data.criteo_stream``) against the JAX package's (``deepctr_tpu/native``,
``deepctr_tpu/data.py``): every parse and every chunk bit for bit, on
files written here (comma- and tab-separated, with and without a header,
a short row, a last line without a newline) and on the vendored
``examples/data/criteo_sample.txt``; and the plain Python parser
(``parse_criteo_ref``) against the library."""

import os

import numpy as np
import pytest

from deepctr_tpu import data as jdata
from deepctr_tpu import native as jnative
from deepctr_tpu_torch import native
from deepctr_tpu_torch.data import criteo_columns, criteo_stream
from deepctr_tpu_torch.models import DeepFM

SAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                      "criteo_sample.txt")


def _write(tmp_path, n=100, n_dense=3, n_sparse=4, header=True, sep=",",
           trailing_newline=True, short_row=True, seed=0):
    """A Criteo-format file: labels, dense values (some empty), hex ids
    (some empty); with ``short_row`` one row stops after its first dense
    field."""
    rng = np.random.default_rng(seed)
    lines = []
    if header:
        lines.append(sep.join(["label"] + ["I%d" % (i + 1)
                                           for i in range(n_dense)]
                              + ["C%d" % (i + 1) for i in range(n_sparse)]))
    for r in range(n):
        f = [str(rng.integers(0, 2))]
        for _ in range(n_dense):
            f.append("" if rng.random() < 0.3
                     else str(round(float(rng.random() * 100 - 5), 2)))
        for _ in range(n_sparse):
            f.append("" if rng.random() < 0.2
                     else "%08x" % rng.integers(0, 2 ** 32))
        if short_row and r == n // 2:
            f = f[:2]
        lines.append(sep.join(f))
    text = "\n".join(lines) + ("\n" if trailing_newline else "")
    p = tmp_path / ("sample.%s" % ("tsv" if sep == "\t" else "csv"))
    p.write_bytes(text.encode())
    return str(p)


def _assert_same_chunks(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert list(gx) == list(wx)
        np.testing.assert_array_equal(gy, wy)
        for k in gx:
            assert gx[k].dtype == wx[k].dtype == np.float32
            np.testing.assert_array_equal(gx[k], wx[k], err_msg=k)


@pytest.mark.parametrize("log_dense", [True, False])
def test_parse_matches_jax_and_the_plain_version(tmp_path, log_dense):
    path = _write(tmp_path, n=200)
    buf = open(path, "rb").read().split(b"\n", 1)[1]
    vocabs = [50, 1000, 7, 123456]
    got = native.parse_criteo(buf, 3, 4, vocabs, log_dense=log_dense)
    want = jnative.parse_criteo(buf, 3, 4, vocabs, log_dense=log_dense)
    plain = native.parse_criteo_ref(buf, 3, 4, vocabs, log_dense=log_dense)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
        # float parsing: strtof and Python's float() agree to rounding
        np.testing.assert_allclose(got[i], plain[i], rtol=1e-6)
    np.testing.assert_array_equal(got[2], plain[2])
    assert got[3] == want[3] == plain[3] == len(buf)


def test_parse_semantics():
    buf = b"1,3,,0.5,aa,,bb\n0,,2.25,7,,cc,\n"
    for parse in (native.parse_criteo, native.parse_criteo_ref):
        y, dense, sparse, consumed = parse(buf, 3, 3, [100, 100, 100],
                                           log_dense=False)
        assert consumed == len(buf)
        np.testing.assert_array_equal(y, [1.0, 0.0])
        np.testing.assert_allclose(dense, [[3.0, 0.0, 0.5],
                                           [0.0, 2.25, 7.0]])
        assert sparse[0, 1] == 0 and sparse[1, 0] == 0 and sparse[1, 2] == 0
        assert sparse[0, 0] == native._fnv1a(b"aa") % 100
        # an incomplete last line is not consumed
        y2, _, _, c2 = parse(buf + b"1,1,1,1,x,y,z", 3, 3, [100, 100, 100])
        assert c2 == len(buf) and len(y2) == 2


def test_parse_short_row_zero_fills():
    buf = b"1,1,2,a,b\n0,5\n"
    for parse in (native.parse_criteo, native.parse_criteo_ref,
                  jnative.parse_criteo):
        y, dense, sparse, consumed = parse(buf, 2, 2, [100, 100],
                                           log_dense=False)
        assert consumed == len(buf)
        np.testing.assert_array_equal(y, [1.0, 0.0])
        np.testing.assert_allclose(dense[1], [5.0, 0.0])
        np.testing.assert_array_equal(sparse[1], [0.0, 0.0])


@pytest.mark.parametrize("sep, header, trailing", [
    (",", True, True), (",", False, False), ("\t", True, False),
    ("\t", False, True)])
def test_stream_chunks_match_jax(tmp_path, sep, header, trailing):
    """Every chunk bit-equal to the JAX stream's, the separator sniffed,
    a header skipped, the short row zero-filled and a last line without
    a newline read; a tiny ``read_bytes`` carries partial lines across
    reads."""
    path = _write(tmp_path, n=57, sep=sep, header=header,
                  trailing_newline=trailing)
    cols = criteo_columns(vocab_size=64, embedding_dim=4, n_dense=3,
                          n_sparse=4)
    jcols = jdata.criteo_columns(vocab_size=64, embedding_dim=4, n_dense=3,
                                 n_sparse=4)
    for chunk_rows, read_bytes in ((10, 64), (1000, 1 << 24)):
        gen = criteo_stream(path, cols, chunk_rows=chunk_rows,
                            read_bytes=read_bytes)
        got = list(gen())
        _assert_same_chunks(got, list(jdata.criteo_stream(
            path, jcols, chunk_rows=chunk_rows, read_bytes=read_bytes)()))
        assert sum(len(y) for _, y in got) == 57
        assert all(len(y) <= chunk_rows for _, y in got)
        # a second call re-opens the file
        _assert_same_chunks(list(gen()), got)


def test_stream_of_the_vendored_sample_matches_jax():
    cols = criteo_columns(vocab_size=10000, embedding_dim=4)
    jcols = jdata.criteo_columns(vocab_size=10000, embedding_dim=4)
    got = list(criteo_stream(SAMPLE, cols, chunk_rows=64)())
    _assert_same_chunks(got, list(jdata.criteo_stream(SAMPLE, jcols,
                                                      chunk_rows=64)()))
    assert sum(len(y) for _, y in got) > 100
    x, y = got[0]
    assert set(np.unique(y)) <= {0.0, 1.0}
    for i in range(1, 27):
        assert ((x["C%d" % i] >= 0) & (x["C%d" % i] < 10000)).all()


def test_stream_fit_end_to_end(tmp_path):
    path = _write(tmp_path, n=300, n_dense=2, n_sparse=3)
    cols = criteo_columns(vocab_size=32, embedding_dim=4, n_dense=2,
                          n_sparse=3)
    model = DeepFM(cols, cols, dnn_hidden_units=(8,), device="cpu")
    model.compile("adagrad", "binary_crossentropy")
    h = model.fit(criteo_stream(path, cols, chunk_rows=128), batch_size=64,
                  epochs=2, verbose=0)
    assert len(h.history["loss"]) == 2
    assert np.isfinite(h.history["loss"]).all()


def test_parse_fuzz_matches_jax():
    """Random byte soup through the library: the same output as the JAX
    package's, ids in range, consumed bounded by the buffer."""
    rng = np.random.default_rng(0)
    alphabet = list(b"0123456789.,-abcXYZ\t\n\r ,")
    for trial in range(300):
        buf = bytes(rng.choice(alphabet, int(rng.integers(0, 200))).tolist())
        nd, ns = int(rng.integers(0, 5)), int(rng.integers(0, 5))
        vocabs = rng.integers(1, 1000, ns).tolist() if ns else [1]
        got = native.parse_criteo(buf, nd, ns, vocabs,
                                  log_dense=bool(trial % 2))
        want = jnative.parse_criteo(buf, nd, ns, vocabs,
                                    log_dense=bool(trial % 2))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3] and 0 <= got[3] <= len(buf)
        if ns and len(got[2]):
            assert ((got[2] >= 0)
                    & (got[2] < np.asarray(vocabs)[None, :])).all()
