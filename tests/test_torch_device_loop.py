"""The port's device-resident loops on the CPU against the JAX package's:
``fit(x=<tensor>)`` (``deepctr_tpu_torch/models/basemodel.py:_fit_device``)
against ``fit(x=<jax.Array>)`` (``deepctr_tpu/models/basemodel.py:
_fit_device``), ``predict`` on a tensor against ``predict`` on a device
array, and the fixed-size pieces of the step that make it capturable: the
touched rows at a fixed capacity and the row update that drops their
padding.

On a CPU model the loop runs its captured body eagerly; the capture and
its replays are held against the eager step on the card by
``chip_smoke.py``.  Both packages start from the same JAX weights, redrawn
at std 0.3, with ``shuffle=False`` and N no multiple of the batch, so
that the last batch of every epoch is padded with zero rows at sample
weight 0."""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_tpu import callbacks as jcb
from deepctr_tpu.models import DIEN as JDIEN
from deepctr_tpu_torch import callbacks as pcb
from deepctr_tpu_torch.models import DIEN as PDIEN
from deepctr_tpu_torch.models import basemodel as pbase
from deepctr_tpu_torch.models import graphs
from deepctr_tpu_torch.ops import row_update as RU
from tests import test_torch_sequence_train as seq
from tests.test_torch_train import L2, _data, _pair, _port_weights_of

N, B = 300, 64          # 5 steps an epoch, the last of 44 rows
EPOCHS = 3
LOSS_RTOL = 1e-5
ATOL = 1e-6


def _fit_both(jm, pm, x, y, opt, epochs=EPOCHS, batch_size=B, **kw):
    """Both models compiled alike and fit on device input; their
    histories."""
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy",
                  **{k: v for k, v in kw.items()
                     if k == "sparse_table_updates"})
    fit_kw = {k: v for k, v in kw.items() if k != "sparse_table_updates"}
    fit_kw.setdefault("verbose", 0)
    hj = jm.fit(jnp.asarray(jm._assemble_x(x)), y, batch_size=batch_size,
                epochs=epochs, shuffle=False, **fit_kw)
    X = pm.assemble_device_input(x)
    assert isinstance(X, torch.Tensor) and X.device == pm._device
    hp = pm.fit(X, y, batch_size=batch_size, epochs=epochs, shuffle=False,
                **fit_kw)
    return hj.history, hp.history


def _jax_states(jm):
    """{(field, JAX path): array} of the JAX model's optimizer state: the
    dense parameters' (``mu``/``nu`` for adam, else the one accumulator)
    and the sparse tables'."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm.opt_state)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        field = next((k for k in keys if k in ("mu", "nu")), "")
        names = [k for k in keys if isinstance(k, str)
                 and k not in ("mu", "nu", "inner_state")]
        if np.ndim(leaf):
            out[(field, "/".join(names))] = np.asarray(leaf)
    for path, st in jm.table_state.items():
        if isinstance(st, dict):
            for field, name in (("mu", "m"), ("nu", "v")):
                out[(field, path)] = np.asarray(st[name])
        elif isinstance(st, jax.Array):
            out[("", path)] = np.asarray(st)
    return out


def _port_states(pm):
    fields = {"adam": ("mu", "nu")}.get(pm._optimizer_name, ("",))
    out = {}
    sparse = set(pm._table_state)
    dense = [path for path, _ in pm._named_params() if path not in sparse]
    for path, st in zip(dense, pm._dense_opt.state):
        for field, a in zip(fields, st):
            # a dense layer's kernel is [out, in] here, [in, out] there
            kernel = path.endswith("/kernel") and a.dim() == 2
            out[(field, path)] = (a.t() if kernel else a).numpy()
    for path, st in pm._table_state.items():
        for field, a in zip(fields, st):
            out[(field, path)] = a.numpy()
    return out


def _assert_same_training(jm, pm, hj, hp, flip=None):
    """Losses, weights and optimizer states.  With ``flip``, a share of at
    most 1e-3 of the weights may differ by up to ``flip``: adagrad's first
    step on a weight is close to ``lr * sign(g)``, so a gradient that
    cancels to about 0 may flip it by 2 lr between two correct
    implementations (``tests/test_torch_train.py``)."""
    assert hp["loss"] and len(hp["loss"]) == len(hj["loss"])
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=LOSS_RTOL)
    want, got = _port_weights_of(jm, pm)
    assert set(want) == set(got)
    n_out, n_all = 0, 0
    for k in want:
        if flip is None:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=k)
            continue
        d = np.abs(got[k] - want[k])
        assert d.max() <= flip, (k, d.max())
        n_out += int((d > ATOL).sum())
        n_all += d.size
    assert n_out <= 1e-3 * n_all, (n_out, n_all)
    if flip is not None:
        return
    # an accumulator grows past 8, where a float32 ulp is above 1e-6:
    # states are held at 1e-6 absolute, or relative above 1
    want, got = _jax_states(jm), _port_states(pm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ATOL, atol=ATOL,
                                   err_msg=str(k))


@pytest.mark.parametrize("opt, sparse", [
    ("adagrad", False), ("sgd", True), ("adagrad", True), ("rmsprop", True),
    ("adam", True)])
def test_device_fit_matches_the_jax_device_loop(opt, sparse):
    """Per-epoch losses at rtol 1e-5, every weight at atol 1e-6 and every
    optimizer state (dense parameters and sparse tables) at 1e-6, relative
    above 1; L2 on every
    group, tables under 131072 rows (ROADMAP section 3)."""
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, N, np.random.default_rng(21))
    hj, hp = _fit_both(jm, pm, x, y, opt, sparse_table_updates=sparse)
    assert bool(pm._sparse_specs) == sparse
    assert ([s[0] for s in jm._sparse_specs]
            == [s[0] for s in pm._sparse_specs])
    _assert_same_training(jm, pm, hj, hp)
    assert pm._dense_opt.count == EPOCHS * (-(-N // B))


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_device_fit_of_dien_augru_with_negatives_matches_jax(opt):
    """DIEN AUGRU with negative sampling, its item and cate tables and the
    user table on the sparse path: the histories' many id columns a table,
    the auxiliary loss and the GRU backward inside the loop.  adagrad's
    weights allow the sign flips of ``_assert_same_training`` (this model
    has one at the attention's output bias); its states are then not
    held."""
    jm, pm = seq._pair(JDIEN, PDIEN, seed=31, use_neg=True,
                       gru_type="AUGRU", use_negsampling=True,
                       att_activation="sigmoid", att_hidden_units=(6, 3))
    x, y = seq._data(seq.N, seed=32)
    epochs = 2
    hj, hp = _fit_both(jm, pm, x, y, opt, epochs=epochs, batch_size=seq.B,
                       sparse_table_updates=True)
    assert len(pm._sparse_specs) == 3
    steps = epochs * (-(-seq.N // seq.B))
    _assert_same_training(jm, pm, hj, hp, flip=None if opt == "sgd" else
                          2 * pm._learning_rate * steps)


def test_predict_on_a_tensor_matches_jax_with_the_last_batch_padded():
    jm, pm, cols = _pair(**L2)
    x, _ = _data(cols, N, np.random.default_rng(22))
    X = pm.assemble_device_input(x)
    want = jm.predict(jnp.asarray(jm._assemble_x(x)), B)
    got = pm.predict(X, B)
    assert got.shape == want.shape == (N, 1) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a tensor on another device than the model's, and host arrays
    np.testing.assert_allclose(pm.predict(X.double(), B), got, rtol=0,
                               atol=0)
    np.testing.assert_allclose(pm.predict(x, B), got, rtol=0, atol=0)


def test_device_fit_train_metrics_come_from_the_whole_epoch():
    """verbose=1: each train metric once over the epoch's predictions, as
    the JAX loop reads them."""
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, N, np.random.default_rng(23))
    metrics = ["auc", "binary_crossentropy", "acc"]
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy", metrics=metrics,
                  sparse_table_updates=True)
    hj = jm.fit(jnp.asarray(jm._assemble_x(x)), y, batch_size=B, epochs=2,
                shuffle=False, verbose=1).history
    hp = pm.fit(pm.assemble_device_input(x), y, batch_size=B, epochs=2,
                shuffle=False, verbose=1).history
    assert set(hp) == set(hj) == {"loss"} | set(metrics)
    for k in hj:
        np.testing.assert_allclose(hp[k], hj[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_device_fit_validation_split_with_early_stopping_matches_jax():
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, 400, np.random.default_rng(24))
    metrics = ["binary_crossentropy", "auc"]
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy", metrics=metrics,
                  sparse_table_updates=True)
    hist = {}
    for name, m, cb, X in (
            ("jax", jm, jcb, jnp.asarray(jm._assemble_x(x))),
            ("port", pm, pcb, pm.assemble_device_input(x))):
        stop = cb.EarlyStopping(monitor="val_auc", patience=1, mode="max")
        hist[name] = m.fit(X, y, batch_size=B, epochs=30, verbose=0,
                           shuffle=False, validation_split=0.25,
                           callbacks=[stop]).history
    assert set(hist["port"]) == set(hist["jax"]) == {
        "loss"} | {"val_" + k for k in metrics}
    assert len(hist["port"]["loss"]) == len(hist["jax"]["loss"]) < 30
    for k in hist["jax"]:
        np.testing.assert_allclose(hist["port"][k], hist["jax"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_device_fit_shuffles_on_the_device_and_still_learns():
    """shuffle=True draws each epoch's permutation from a generator seeded
    with the model's seed: two fits of one model from the same weights
    give the same losses, and the loss falls."""
    _, pm, cols = _pair(**L2)
    x, y = _data(cols, N, np.random.default_rng(25))
    pm.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    start = pm.get_weights()
    X = pm.assemble_device_input(x)
    first = pm.fit(X, y, batch_size=B, epochs=4, verbose=0).history["loss"]
    pm.set_weights(start)
    again = pm.fit(X, y, batch_size=B, epochs=4,
                   verbose=0).history["loss"][-4:]
    assert again == first[-4:]
    assert first[-1] < first[0]


def test_an_id_outside_its_table_raises_before_any_step():
    """The fixed-size step reads no count back: the ids are checked once,
    on the numpy matrix (host arrays) or by one reduction (a tensor)."""
    _, pm, cols = _pair()
    x, y = _data(cols, 64, np.random.default_rng(26))
    pm.compile("sgd", "binary_crossentropy", sparse_table_updates=True)
    start = pm.get_weights()
    x["s2"][5] = 1000
    for arg in (x, pm.assemble_device_input(x)):
        with pytest.raises(ValueError, match="outside its table"):
            pm.fit(arg, y, batch_size=32, verbose=0)
    for k, v in pm.get_weights().items():
        np.testing.assert_array_equal(v, start[k])


def _touched_by_unique(X, specs):
    """The touched rows as ``torch.unique`` finds them: per table its sorted
    distinct ids with row 0, and each id column's slots."""
    rows, slots = [], []
    for _, spans, _ in specs:
        cols = [c for s, e in spans for c in range(s, e)]
        ids = X[:, cols].to(torch.int32).to(torch.int64)
        uniq, inv = torch.unique(torch.cat([ids.new_zeros(1),
                                            ids.t().reshape(-1)]),
                                 return_inverse=True)
        rows.append(uniq)
        slots.append(inv[1:].view(len(cols), -1).t())
    return rows, torch.cat(slots, dim=1)


@pytest.mark.parametrize("case", ["duplicates", "row 0", "full tables"])
def test_fixed_size_touched_rows_match_torch_unique(case):
    """Each table's rows are the distinct ids with row 0, ascending, then
    padding past the table, ascending, up to min(1 + B * columns, V) rows;
    slots as
    ``torch.unique``'s inverse.  Duplicates inside a batch, a batch of
    row 0 only, and tables every one of whose rows a batch touches (its
    capacity then V, no padding)."""
    _, pm, cols = _pair(big=[20000])
    pm.compile("sgd", "binary_crossentropy", sparse_table_updates=True)
    specs = pm._sparse_specs
    rng = np.random.default_rng(27)
    Bt = 200
    x, _ = _data(cols, Bt, rng)
    if case == "duplicates":
        x = {k: np.concatenate([v[:20]] * 10) for k, v in x.items()}
    elif case == "row 0":
        x = {k: np.zeros_like(v) for k, v in x.items()}
    else:
        for fc in cols:
            if isinstance(fc, pbase.SparseFeat) and fc.vocabulary_size <= Bt:
                x[fc.name] = np.arange(Bt) % fc.vocabulary_size
    X = torch.from_numpy(pm._assemble_x(x))
    touched = pm._touched_rows(X)
    want_rows, want_slots = _touched_by_unique(X, specs)
    plan = pm._step_plan(Bt)
    for t, ((path, spans, V), got, want) in enumerate(
            zip(specs, touched.rows, want_rows)):
        n_cols = sum(e - s for s, e in spans)
        cap = min(1 + Bt * n_cols, V)
        assert plan.caps[t] == cap and got.shape == (cap,), path
        n = want.shape[0]
        assert torch.equal(got[:n], want), path
        assert torch.equal(got[n:], V + torch.arange(n, cap)), path
        assert touched.grads[t].shape == (cap, pm._tables()[path].shape[1])
        if case == "full tables" and V <= Bt:
            assert n == V == cap
    assert torch.equal(touched.slots, want_slots)
    assert all(not g.any() for g in touched.grads)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rmsprop", "adam"])
def test_row_update_ref_drops_the_padded_rows(opt):
    """Rows at or past the table (the fixed capacity's padding) are
    neither read nor written, whatever their gradient; the listed rows
    that lie in the table update as when listed alone."""
    rng = np.random.default_rng(28)
    V, W = 50, 9
    w = torch.from_numpy(rng.normal(size=(V, W)).astype(np.float32))
    states = tuple(torch.from_numpy(rng.random((V, W)).astype(np.float32))
                   for _ in range(RU.MODES[opt][1]))
    valid = torch.from_numpy(np.sort(rng.choice(V, 12, replace=False)))
    rows = torch.cat([valid, V + torch.arange(5)])
    g = torch.from_numpy(rng.normal(size=(17, W)).astype(np.float32))
    l2 = torch.full((W,), 1e-3)
    bias = ([torch.tensor(RU.adam_bias_corrections(4))]
            if opt == "adam" else None)
    got_w, got_s = w.clone(), tuple(s.clone() for s in states)
    RU.row_update(opt, [got_w], [got_s], [g], [rows], [l2], 0.01, bias)
    want_w, want_s = w.clone(), tuple(s.clone() for s in states)
    RU.row_update(opt, [want_w], [want_s], [g[:12]], [valid], [l2], 0.01,
                  bias)
    assert torch.equal(got_w, want_w)
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)
    untouched = torch.ones(V, dtype=torch.bool)
    untouched[valid] = False
    assert torch.equal(got_w[untouched], w[untouched])
    assert not torch.equal(got_w[valid], w[valid])


def test_fit_on_a_tensor_after_host_fit_continues_the_optimizer():
    """Both loops share the step: a host-array epoch then a device one
    equal two device epochs (adam, whose bias corrections follow the step
    count across the two)."""
    _, a, cols = _pair(**L2)
    _, b, _ = _pair(**L2)
    x, y = _data(cols, 256, np.random.default_rng(29))
    for m in (a, b):
        m.compile("adam", "binary_crossentropy", sparse_table_updates=True)
    X = a.assemble_device_input(x)
    a.fit(x, y, batch_size=B, epochs=1, verbose=0, shuffle=False)
    a.fit(X, y, batch_size=B, epochs=1, verbose=0, shuffle=False)
    b.fit(X, y, batch_size=B, epochs=2, verbose=0, shuffle=False)
    assert a._dense_opt.count == b._dense_opt.count == 8
    for k, v in a.get_weights().items():
        np.testing.assert_allclose(v, b.get_weights()[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_the_captured_body_reads_nothing_back_from_the_device():
    """The step's path holds no host read of a tensor: no ``torch.unique``,
    ``.tolist()``, ``.item()``, ``float(``, ``bool(`` or ``.cpu()`` in the
    code a step runs."""
    bodies = [pbase._TouchedRows, pbase.BaseModel._train_step,
              pbase.BaseModel._scatter_targets,
              pbase.BaseModel._scatter_row_grads,
              pbase.BaseModel._update_touched_rows, pbase.DenseOptimizer.step,
              graphs.StepGraph.step, graphs.ForwardGraph.run]
    for body in bodies:
        src = inspect.getsource(body)
        for word in (r"torch\.unique", r"\.tolist\(\)", r"\.item\(\)",
                     r"(?<![\w.])float\(", r"(?<![\w.])bool\(",
                     r"\.cpu\(\)"):
            assert not re.search(word, src), (body, word)


@pytest.mark.parametrize("change", ["set_weights", "compile", "to",
                                    "load_state_dict"])
def test_a_change_of_tensors_drops_the_captured_graphs(change):
    """Each of these makes new tensors (or new optimizer state): a graph
    holding the old addresses would update freed memory, so the model
    drops its graphs and step plans."""
    _, pm, cols = _pair()
    x, y = _data(cols, 128, np.random.default_rng(30))
    pm.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    pm.fit(pm.assemble_device_input(x), y, batch_size=B, verbose=0)
    pm.predict(x, B)
    assert pm._plans and pm._graphs
    released = []
    for g in pm._graphs.values():
        g.release = (lambda g=g: released.append(g))
    n = len(pm._graphs)
    if change == "set_weights":
        pm.set_weights(pm.get_weights())
    elif change == "compile":
        pm.compile("adagrad", "binary_crossentropy")
    elif change == "to":
        pm.to("cpu", torch.float32)
    else:
        pm.load_state_dict(pm.state_dict())
    assert len(released) == n and not pm._graphs and not pm._plans
