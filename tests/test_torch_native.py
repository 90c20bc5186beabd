"""The port's native batcher (``deepctr_tpu_torch/native``) and
``SparseFeat(use_hash=True)`` against the JAX package's
(``deepctr_tpu/native``, ``deepctr_tpu/models/basemodel.py:1413-1467``).

The library and both packages' assembly and hashing are held bit for bit:
the same C++ source and the same numpy arguments.  A hashed DeepFM is held
to the JAX model from the same weights: predictions within 1e-6, and the
weights after a fit within 1e-5 relative (float32 sums in other orders,
as tests/test_torch_train.py holds DeepFM)."""

import threading

import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import native as jnative
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu_torch import native
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights
from tests.test_torch_train import _port_weights_of, _redraw

I64 = np.iinfo(np.int64)


def test_native_builds_into_the_ports_build_directory():
    assert native.load() is native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "deepctr_tpu_torch"
    assert path.name.startswith("libbatcher-") and path.suffix == ".so"
    # the port builds the JAX package's source as it is
    assert native.SRC.read_bytes() == open(
        jnative._SRC, "rb").read()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No silent numpy path: a source g++ refuses raises, and so does
    every entry point that needs the library."""
    bad = tmp_path / "batcher.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load()
    with pytest.raises(RuntimeError):
        native.assemble([np.zeros((2, 1), np.float32)])
    with pytest.raises(RuntimeError):
        native.hash_to_bucket(np.arange(3), 7)
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_builds_at_once_each_write_their_own_file(monkeypatch, tmp_path):
    """Processes (here threads past the lock) that build at once write
    temporary files of their own and rename them into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    path = native.library_path()
    errors = []

    def build():
        try:
            native._build(path)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in path.parent.iterdir()] == [path.name]


@pytest.mark.parametrize("widths", [(1,), (1, 3, 1, 7, 2), (16, 1, 5)])
def test_assemble_matches_jax_and_the_plain_version(widths):
    rng = np.random.default_rng(len(widths))
    arrays = [rng.random((5000, w)).astype(np.float32) for w in widths]
    got = native.assemble(arrays)
    np.testing.assert_array_equal(got, jnative.assemble(arrays))
    np.testing.assert_array_equal(got, native.assemble_ref(arrays))


def test_assemble_rejects_mismatched_rows():
    arrays = [np.zeros((100, 2), np.float32), np.zeros((99, 2), np.float32)]
    for fn in (native.assemble, native.assemble_ref):
        with pytest.raises(ValueError, match="same number of rows"):
            fn(arrays)


def test_take_rows_matches_jax_and_the_plain_version():
    rng = np.random.default_rng(0)
    m = rng.random((500, 17)).astype(np.float32)
    idx = rng.integers(0, 500, 123)
    got = native.take_rows(m, idx)
    np.testing.assert_array_equal(got, jnative.take_rows(m, idx))
    np.testing.assert_array_equal(got, native.take_rows_ref(m, idx))
    with pytest.raises(IndexError):
        native.take_rows(m, np.array([500]))


@pytest.mark.parametrize("values, vocab", [
    (np.array([1, 2, 3, 1, 10 ** 12, 0, -1, -7]), 997),
    (np.array([I64.min, I64.max, I64.min + 1, I64.max - 1, 0]), 1_000_003),
    (np.arange(-50, 50, dtype=np.int32).reshape(10, 10), 13),
    (np.array(["apple", "banana", "", "apple", "0", "Ω", "a\tb"], object),
     1000),
    (np.array(["x", "yy", "zzz"]), 2 ** 40),
    ([b"\x00\xff", b"", b"criteo"], 50),
])
def test_hash_to_bucket_matches_jax_and_the_plain_version(values, vocab):
    got = native.hash_to_bucket(values, vocab)
    want = jnative.hash_to_bucket(values, vocab)
    assert got.dtype == np.int64 and got.shape == np.shape(values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.hash_to_bucket_ref(values,
                                                                 vocab))
    assert ((got >= 0) & (got < vocab)).all()


def _hash_columns(m):
    return [m.SparseFeat("city", 50, 4, use_hash=True),
            m.SparseFeat("uid", 40, 4, use_hash=True),
            m.SparseFeat("plain", 20, 4), m.DenseFeat("d", 1),
            m.VarLenSparseFeat(m.SparseFeat("tags", 30, 4, use_hash=True),
                               maxlen=3, combiner="mean"),
            m.VarLenSparseFeat(m.SparseFeat("hist", 25, 4, use_hash=True,
                                            embedding_name="uid"),
                               maxlen=4, combiner="sum")]


def _hash_inputs(n, seed):
    """Strings with empties, int64 ids at their extremes given as floats
    and ints, varlen strings padded with '' and varlen ints padded with 0."""
    rng = np.random.default_rng(seed)
    cities = np.array(["nyc", "sfo", "ber", "tok", "par", "Ω"])
    tags = np.array(["", "a", "bb", "ccc"])
    uid = rng.integers(-10 ** 6, 10 ** 6, n)
    uid[:2] = [0, -1]
    hist = rng.integers(1, 10 ** 9, (n, 4))
    hist[rng.random((n, 4)) < 0.4] = 0
    x = {"city": cities[rng.integers(0, len(cities), n)],
         "uid": uid.astype(np.float64),
         "plain": rng.integers(0, 20, n),
         "d": rng.random(n).astype(np.float32),
         "tags": tags[rng.integers(0, len(tags), (n, 3))],
         "hist": hist}
    y = (x["city"] == "nyc").astype(np.float32)
    return x, y


def test_assembly_hashes_as_the_jax_package():
    """``_assemble_x`` bit-equal to the JAX package's: strings and ints
    hashed, floats cast to int64 first, a ``VarLenSparseFeat``'s id 0 and
    empty strings kept at 0, unhashed columns as they are."""
    cols = _hash_columns(pt)
    pm = PDeepFM(cols, cols, dnn_hidden_units=(8,), device="cpu")
    jm = JDeepFM(_hash_columns(dt), _hash_columns(dt), dnn_hidden_units=(8,))
    x, _ = _hash_inputs(64, 0)
    got = pm._assemble_x(x)
    np.testing.assert_array_equal(got, jm._assemble_x(x))
    idx = pm.feature_index
    s, e = idx["tags"]
    empty = x["tags"] == ""
    assert empty.any() and (got[:, s:e][empty] == 0).all()
    s, e = idx["hist"]
    pad = x["hist"] == 0
    assert pad.any() and (got[:, s:e][pad] == 0).all()
    # a city hashes its empty string as any other: no padding rule there
    assert native.hash_to_bucket(np.array([""]), 50)[0] != 0
    s, _ = idx["uid"]
    np.testing.assert_array_equal(
        got[:, s], native.hash_to_bucket(x["uid"].astype(np.int64), 40))
    np.testing.assert_array_equal(got[:, idx["plain"][0]], x["plain"])
    assert set(pm._hash_feats) == {"city", "uid", "tags", "hist"}


def test_fit_rejects_mismatched_feature_lengths():
    rng = np.random.default_rng(0)
    cols = [pt.SparseFeat("C1", 10, 4), pt.SparseFeat("C2", 10, 4)]
    m = PDeepFM(cols, cols, device="cpu")
    m.compile("adagrad", "binary_crossentropy")
    x = {"C1": rng.integers(0, 10, 64), "C2": rng.integers(0, 10, 32)}
    with pytest.raises(ValueError, match="inconsistent sample counts"):
        m.fit(x, rng.integers(0, 2, 64).astype("float32"), batch_size=32,
              verbose=0)


def _hash_pair(seed):
    jm = JDeepFM(_hash_columns(dt), _hash_columns(dt), dnn_hidden_units=(8,))
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"],
                                np.random.default_rng(seed))
    jm.set_weights(weights)
    pm = PDeepFM(_hash_columns(pt), _hash_columns(pt), dnn_hidden_units=(8,),
                 device="cpu")
    load_jax_weights(pm, weights)
    return jm, pm


def test_use_hash_deepfm_predicts_and_fits_as_the_jax_package():
    """Raw string and int64 ids through a hashed DeepFM: predictions
    within 1e-6 of the JAX model's, then two epochs of adagrad from the
    same weights and every weight within 1e-5 relative."""
    jm, pm = _hash_pair(1)
    x, y = _hash_inputs(96, 2)
    np.testing.assert_allclose(pm.predict(x, 32), jm.predict(x, 32),
                               rtol=0, atol=1e-6)
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy")
    hj = jm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False)
    hp = pm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=1e-5)
    want, got = _port_weights_of(jm, pm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(pm.predict(x, 32), jm.predict(x, 32),
                               rtol=0, atol=1e-6)


def test_use_hash_learns_a_planted_signal_on_strings():
    """SparseFeat(use_hash=True) trains on raw strings (the JAX package's
    tests/test_native.py case, fewer epochs)."""
    rng = np.random.default_rng(0)
    N = 128
    cities = np.array(["nyc", "sfo", "ber", "tok", "par"])
    c0 = cities[rng.integers(0, 5, N)]
    y = (c0 == "nyc").astype(np.float64)
    cols = [pt.SparseFeat("city", 50, 4, use_hash=True),
            pt.SparseFeat("other", 20, 4)]
    x = {"city": c0, "other": rng.integers(0, 20, N)}
    model = PDeepFM(cols, cols, dnn_hidden_units=(8,), device="cpu")
    model.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    h = model.fit(x, y, batch_size=64, epochs=15, validation_split=0.25,
                  verbose=0)
    assert h.history["val_auc"][-1] > 0.9
    assert torch.isfinite(model.embedding_dict.tables["city"]).all()
