"""The port's serving artifacts of the models whose forward runs the
sequence and CIN kernels (DIN, DIEN, xDeepFM) beside DeepFM, on the CPU:
the exported graph calls each kernel's custom operator
(``deepctr_tpu_torch::gather_rows``, ``din_attention_fused``,
``gru_scan``, ``cin_mix``; ``ops/library.py``), and the artifact agrees
with the port's ``predict`` and the JAX package's artifact within 1e-6,
from the same JAX weights (tests/test_torch_serving.py holds the rest)."""

import jax.numpy as jnp
import numpy as np
import pytest

from deepctr_tpu import serving as jserving
from deepctr_tpu_torch import serving
from tests import test_torch_sequence_train as seq
from tests import test_torch_xdeepfm as xd
from tests.test_torch_serving import _close, _deepfm_pair, _ops


def _din_dien(kind):
    if kind == "din":
        jm, pm = seq._pair(seq.JDIN, seq.PDIN, seed=51,
                           att_hidden_size=(6, 3), att_activation="sigmoid")
    else:
        jm, pm = seq._pair(seq.JDIEN, seq.PDIEN, seed=52, gru_type="GRU",
                           att_hidden_units=(6, 3), att_activation="sigmoid")
    x, _ = seq._data(24, seed=53)
    return jm, pm, x


@pytest.mark.parametrize("kind, ops", [
    ("deepfm", {"gather_rows"}),
    ("din", {"gather_rows", "din_attention_fused"}),
    ("dien", {"gather_rows", "din_attention_fused", "gru_scan"}),
    ("xdeepfm", {"gather_rows", "cin_mix"})])
def test_exported_graphs_call_the_kernels_operators(kind, ops):
    """DeepFM, DIN (sigmoid), DIEN (GRU) and xDeepFM exported with a
    symbolic batch: the graph calls the ``deepctr_tpu_torch::`` operators
    of their kernels, and the artifact matches the port's ``predict`` and
    the JAX package's artifact at B = 1, 7 and 24."""
    if kind == "deepfm":
        jm, pm, x = _deepfm_pair(24)
    elif kind == "xdeepfm":
        jm, pm, cols = xd._pair(n_sparse=3, n_dense=2, seed=54,
                                cin_layer_size=(4, 4))
        x, _ = xd._data(cols, 24, np.random.default_rng(55))
    else:
        jm, pm, x = _din_dien(kind)
    exp = serving.export_predict(pm)
    assert _ops(exp) == ops
    jexp = jserving.export_predict(jm)
    X = pm._assemble_x(x)
    for b in (1, 7, 24):
        got = exp.call(X[:b]).numpy()
        _close(got, pm.predict({k: v[:b] for k, v in x.items()}, 24))
        _close(got, jexp.call(jnp.asarray(X[:b])))


def test_an_id_outside_its_table_gives_nan_as_the_jax_artifact():
    jm, pm, x = _deepfm_pair(8)
    X = pm._assemble_x(x)
    X[3, pm.feature_index["C2"][0]] = 9          # C2 has 9 rows
    got = serving.export_predict(pm, batch_size=8).call(X).numpy()
    want = np.asarray(jserving.export_predict(jm, batch_size=8).call(
        jnp.asarray(X)))
    assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
    _close(np.delete(got, 3, 0), np.delete(want, 3, 0))
