"""The port's train-state checkpoints (``deepctr_tpu_torch/utils/
serialization.py``) and ``ModelCheckpoint``, mirroring
``tests/test_checkpoint.py`` and ``tests/test_callbacks.py``, on the CPU.

An uninterrupted fit of two epochs and a fit of one epoch, a checkpoint, a
fresh model that loads it and a ``fit(initial_epoch=1)`` end bit-equal
(weights, the dense and sparse optimizer states, adam's step counts), on
the host-array loop and on the device-resident one, with dense and sparse
tables, under adagrad and adam, with dropout on and the shuffle on: every
step's permutation and masks are a function of (seed, epoch, step).  A
saved state of another layout raises.  Against the JAX package: a JAX
model and the port's copy of it each checkpoint and resume from the same
weights, and end within 1e-6 of each other (``tests/test_torch_device_loop.
py``'s bound: float32 sums in another order)."""

import os

import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu_torch import callbacks as pcb
from deepctr_tpu_torch.models import DeepFM
from deepctr_tpu_torch.utils import serialization
from tests.test_torch_device_loop import _jax_states, _port_states
from tests.test_torch_train import _data, _pair, _port_weights_of

HIDDEN = (8,)


def _cols():
    return [pt.SparseFeat("c0", 50, 4), pt.SparseFeat("c1", 30, 4),
            pt.DenseFeat("d0", 1)]


def _xy(n=192, seed=0):
    rng = np.random.default_rng(seed)
    x = {"c0": rng.integers(0, 50, n), "c1": rng.integers(0, 30, n),
         "d0": rng.random(n)}
    return x, rng.integers(0, 2, n).astype(np.float64)


def _build(opt, sparse, dropout=0.5, cols=None, **kw):
    cols = cols or _cols()
    m = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, dnn_dropout=dropout,
               seed=3, device="cpu", **kw)
    m.compile(opt, "binary_crossentropy", sparse_table_updates=sparse)
    return m


def _train_state(m):
    """Every tensor training moves, by name, and the step counts."""
    out = {k: v.clone() for k, v in m.state_dict().items()}
    for i, st in enumerate(m._dense_opt.state):
        for j, a in enumerate(st):
            out["dense %d/%d" % (i, j)] = a.clone()
    for p, st in m._table_state.items():
        for j, a in enumerate(st):
            out["%s/%d" % (p, j)] = a.clone()
    return out, (m._dense_opt.count, dict(m._table_t))


def _assert_bit_equal(a, b):
    (ta, ca), (tb, cb) = _train_state(a), _train_state(b)
    assert ca == cb
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("opt, sparse", [
    ("adagrad", False), ("adagrad", True), ("adam", False), ("adam", True)])
@pytest.mark.parametrize("loop", ["host", "device"])
def test_checkpoint_resume_is_bit_equal_to_the_uninterrupted_fit(
        tmp_path, loop, opt, sparse):
    x, y = _xy()
    ref = _build(opt, sparse)
    assert bool(ref._sparse_specs) == sparse
    X = ref.assemble_device_input(x) if loop == "device" else x
    ref.fit(X, y, batch_size=64, epochs=2, verbose=0)

    m = _build(opt, sparse)
    m.fit(X, y, batch_size=64, epochs=1, verbose=0)
    m.save_checkpoint(str(tmp_path / "ckpt"))
    resumed = _build(opt, sparse)
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    _assert_bit_equal(resumed, m)
    resumed.fit(X, y, batch_size=64, epochs=2, initial_epoch=1, verbose=0)
    _assert_bit_equal(resumed, ref)
    if sparse:
        assert set(resumed._table_t.values()) == {6}


def test_checkpoint_exact_resume(tmp_path):
    np.random.seed(0)
    x, y = _xy(128)
    m = _build("adam", "auto", dropout=0)
    m.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=False)
    ckpt = os.path.join(str(tmp_path), "ckpt")
    m.save_checkpoint(ckpt)
    m.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
          initial_epoch=2)
    p_cont = m.predict(x, 64)
    m2 = _build("adam", "auto", dropout=0)
    m2.load_checkpoint(ckpt)
    m2.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
           initial_epoch=2)
    np.testing.assert_array_equal(p_cont, m2.predict(x, 64))


def test_checkpoint_without_optimizer(tmp_path):
    x, y = _xy(128)
    m = _build("adam", "auto")
    m.fit(x, y, batch_size=64, epochs=1, verbose=0)
    ckpt = os.path.join(str(tmp_path), "ckpt2")
    m.save_checkpoint(ckpt, include_optimizer=False)
    payload = torch.load(os.path.join(ckpt, serialization.CHECKPOINT_FILE),
                         weights_only=True)
    assert set(payload) == {"version", "weights"}
    m2 = _build("adam", "auto")
    m2.load_checkpoint(ckpt)
    np.testing.assert_array_equal(m.predict(x, 64), m2.predict(x, 64))
    # the optimizer starts afresh
    assert m2._dense_opt.count == 0
    assert all(not a.any() for st in m2._dense_opt.state for a in st)


def test_checkpoint_exact_resume_sparse_adagrad(tmp_path):
    x, y = _xy(192)

    def build():
        return _build("adagrad", True, dropout=0)

    m = build()
    assert m._sparse_specs
    m.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=False)
    ckpt = os.path.join(str(tmp_path), "ckpt_sparse")
    m.save_checkpoint(ckpt)
    m.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
          initial_epoch=2)
    p_cont = m.predict(x, 64)
    m2 = build()
    m2.load_checkpoint(ckpt)
    m2.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
           initial_epoch=2)
    np.testing.assert_array_equal(p_cont, m2.predict(x, 64))


def test_checkpoint_exact_resume_adam_table_step_counts(tmp_path):
    """Stands in for the JAX package's ``combined3`` case (adam's moments
    and per-table step count in one interleaved array, which the port
    does not have): the sparse tables' moments and ``_table_t`` restore,
    or the bias correction after the resume would differ."""
    cols = [pt.SparseFeat("big", 2048, 16), pt.DenseFeat("d0", 1)]
    rng = np.random.default_rng(0)
    x = {"big": rng.integers(0, 2048, 192), "d0": rng.random(192)}
    y = rng.integers(0, 2, 192).astype(np.float64)

    def build():
        return _build("adam", True, dropout=0, cols=cols,
                      l2_reg_embedding=0, l2_reg_linear=0)

    m = build()
    m.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=False)
    ckpt = os.path.join(str(tmp_path), "ckpt_adam")
    m.save_checkpoint(ckpt)
    m.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
          initial_epoch=2)
    m2 = build()
    m2.load_checkpoint(ckpt)
    assert m2._table_t["embedding_dict/big"] == 6
    m2.fit(x, y, batch_size=64, epochs=4, verbose=0, shuffle=False,
           initial_epoch=2)
    _assert_bit_equal(m2, m)


def test_checkpoint_rejects_mismatched_table_state_layout(tmp_path):
    x, y = _xy(96)
    m = _build("adagrad", True)
    assert m._sparse_specs
    m.fit(x, y, batch_size=32, epochs=1, verbose=0)
    ckpt = os.path.join(str(tmp_path), "ckpt_layout")
    m.save_checkpoint(ckpt)
    # the same name under another sparse setting: another layout
    m2 = _build("adagrad", False)
    with pytest.raises(ValueError, match="layout does not match"):
        m2.load_checkpoint(ckpt)
    # adagrad's one accumulator a parameter where adam keeps two moments
    for sparse in (True, False):
        m3 = _build("adam", sparse)
        with pytest.raises(ValueError, match="does not match"):
            m3.load_checkpoint(ckpt)
    # a model of other widths: its weights do not load
    m4 = DeepFM(_cols(), _cols(), dnn_hidden_units=(16,), device="cpu")
    m4.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        m4.load_checkpoint(ckpt)


def test_a_checkpoint_file_loads_with_weights_only(tmp_path):
    """Weights and checkpoints hold tensors, numbers and strings: they
    load under ``torch.load(weights_only=True)``; only a whole-model file,
    which holds its class, needs ``weights_only=False``."""
    x, y = _xy(64)
    m = _build("adam", True)
    m.fit(x, y, batch_size=32, epochs=1, verbose=0)
    m.save_checkpoint(str(tmp_path / "c"))
    m.save_weights(str(tmp_path / "w.pt"))
    m.save(str(tmp_path / "m.pt"))
    for path in (tmp_path / "c" / serialization.CHECKPOINT_FILE,
                 tmp_path / "w.pt"):
        payload = torch.load(str(path), weights_only=True)
        assert payload
    with pytest.raises(Exception):
        torch.load(str(tmp_path / "m.pt"), weights_only=True)
    m2 = pt.load_model(str(tmp_path / "m.pt"))
    assert type(m2) is DeepFM and m2._init_kwargs["dnn_dropout"] == 0.5
    np.testing.assert_array_equal(m2.predict(x, 32), m.predict(x, 32))


def test_load_checkpoint_drops_the_captured_graphs(tmp_path):
    """A load replaces the weights and optimizer state: every graph and
    step plan that held the old tensors' addresses goes."""
    x, y = _xy(64)
    m = _build("adagrad", True)
    X = m.assemble_device_input(x)
    m.fit(X, y, batch_size=32, epochs=1, verbose=0)
    m.save_checkpoint(str(tmp_path / "c"))
    assert m._graphs and m._plans
    m.load_checkpoint(str(tmp_path / "c"))
    assert not m._graphs and not m._plans


@pytest.mark.parametrize("opt, sparse", [("adagrad", True), ("adam", False)])
def test_jax_and_port_resume_to_the_same_weights(tmp_path, opt, sparse):
    """A JAX model and the port's copy of it, from the same weights, each
    fit one epoch, checkpoint, load into a fresh model and fit the
    second: their weights and optimizer states agree at 1e-6 (relative
    above 1)."""
    jm, pm, cols = _pair()
    x, y = _data(cols, 150, np.random.default_rng(3))
    start = jm.get_weights()
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", sparse_table_updates=sparse)
    jm.fit(x, y, batch_size=32, epochs=1, verbose=0, shuffle=False)
    pm.fit(x, y, batch_size=32, epochs=1, verbose=0, shuffle=False)
    jm.save_checkpoint(str(tmp_path / "jax"))
    pm.save_checkpoint(str(tmp_path / "port"))
    jm2, pm2, _ = _pair()
    jm2.set_weights(start)
    for m in (jm2, pm2):
        m.compile(opt, "binary_crossentropy", sparse_table_updates=sparse)
    jm2.load_checkpoint(str(tmp_path / "jax"))
    pm2.load_checkpoint(str(tmp_path / "port"))
    jm2.fit(x, y, batch_size=32, epochs=2, initial_epoch=1, verbose=0,
            shuffle=False)
    pm2.fit(x, y, batch_size=32, epochs=2, initial_epoch=1, verbose=0,
            shuffle=False)
    assert bool(pm2._sparse_specs) == sparse
    want, got = _port_weights_of(jm2, pm2)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    want, got = _jax_states(jm2), _port_states(pm2)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=str(k))


def _bump(m, delta):
    m.set_weights({k: v + delta for k, v in m.get_weights().items()})


def test_model_checkpoint_save_best_only(tmp_path):
    cols = [pt.SparseFeat("c", 10, 4)]
    m = DeepFM(cols, cols, seed=3, device="cpu")
    m.compile("adagrad", "binary_crossentropy")
    x = {"c": np.arange(10)}
    path = os.path.join(str(tmp_path), "best.pt")
    ck = pcb.ModelCheckpoint(path, monitor="val_auc", mode="max",
                             save_best_only=True)
    ck.set_model(m)
    ck.on_epoch_end(0, {"val_auc": 0.60})
    assert os.path.exists(path)
    best_pred = m.predict(x, 16)
    saved_mtime = os.path.getmtime(path)
    # worse epoch: file must NOT be rewritten
    _bump(m, 0.5)
    ck.on_epoch_end(1, {"val_auc": 0.50})
    assert os.path.getmtime(path) == saved_mtime
    # the saved artifact reloads to the best epoch's predictions
    np.testing.assert_array_equal(pt.load_model(path).predict(x, 16),
                                  best_pred)
    # better epoch: file rewritten
    ck.on_epoch_end(2, {"val_auc": 0.80})
    np.testing.assert_array_equal(pt.load_model(path).predict(x, 16),
                                  m.predict(x, 16))


def test_model_checkpoint_period_weights_only_and_missing_metric(
        tmp_path, capsys):
    """Every ``period`` epochs, the path formatted with the epoch and the
    logs; weights only where asked; a missing monitored metric saves
    nothing and says which metrics the logs have, as the JAX callback."""
    cols = [pt.SparseFeat("c", 10, 4)]
    m = DeepFM(cols, cols, seed=3, device="cpu")
    ck = pcb.ModelCheckpoint(os.path.join(str(tmp_path), "w{epoch}.pt"),
                             save_weights_only=True, period=2)
    ck.set_model(m)
    for epoch in range(4):
        ck.on_epoch_end(epoch, {"loss": 0.5})
    assert sorted(os.listdir(str(tmp_path))) == ["w2.pt", "w4.pt"]
    weights = torch.load(os.path.join(str(tmp_path), "w2.pt"),
                         weights_only=True)
    assert set(weights) == set(m.state_dict())
    best = pcb.ModelCheckpoint(os.path.join(str(tmp_path), "b.pt"),
                               save_best_only=True)
    best.set_model(m)
    best.on_epoch_end(0, {"loss": 0.5})
    assert not os.path.exists(os.path.join(str(tmp_path), "b.pt"))
    assert "'val_loss' missing from logs (have: loss)" in \
        capsys.readouterr().out
    jck = dt.ModelCheckpoint("unused", monitor="val_auc")
    pck = pcb.ModelCheckpoint("unused", monitor="val_auc")
    assert (jck.monitor_op, jck.best) == (pck.monitor_op, pck.best)
