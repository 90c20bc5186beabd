"""The bfloat16 parity check of the port's zoo against the JAX package,
shared by ``tests/test_torch_bf16_zoo*.py``.

For each model of ``tests/test_bf16_zoo.py``, on its inputs (numpy seed 7,
``get_test_data`` / ``get_mtl_test_data`` / the DIN and DIEN fixtures) and
its weights (the JAX model's ``seed=5`` init, carried into the port with
``load_jax_weights``): ``predict``, one adagrad step on the first batch,
``predict`` again, run by the JAX package at float32 and at bfloat16
compute and by the port at both.  The bound of a model is the JAX
package's own bfloat16-against-float32 gap (max abs over the
predictions): the port's bfloat16 must lie within it of the JAX package's
bfloat16, before and after the step (:func:`check`).

The readings that miss it are recorded (``RECORDED``, ROADMAP.md section
3), each held to what explains it:

- ``"reorder"``: after the step, at the zoo's init (every prediction
  0.5, gradients that cancel to rounding), adagrad's first step of about
  ``lr * sign(g)`` turns rounding into steps of +-lr.  The JAX package's
  own bfloat16 run with the batch's rows in reverse order (the same sums
  in another order) parts from its run by as much: the port is held to
  twice that witness.
- ``"accuracy"``: the two packages round at other places, and the port's
  bfloat16 is as close to the JAX package's float32 as the JAX package's
  own bfloat16 is (within the float32 gap of the two packages).
"""

import numpy as np

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import config as dc_config
from deepctr_tpu import models as jzoo
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch import models as pzoo
from deepctr_tpu_torch.models import multitask as pmt
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights
from tests.utils import get_test_data
from tests.utils_mtl import get_mtl_test_data

SINGLE_TASK = ["WDL", "DeepFM", "xDeepFM", "NFM", "AFM", "DCN", "DCNMix",
               "AutoInt", "ONN", "PNN", "CCPM", "IFM", "DIFM", "AFN",
               "FiBiNET", "MLR"]
MULTI_TASK = ["SharedBottom", "ESMM", "MMOE", "PLE"]
SEQUENCE = ["DIN", "DIEN"]


def port_columns(cols):
    """The port's copy of the JAX package's feature columns."""
    out = []
    for c in cols:
        if isinstance(c, dt.VarLenSparseFeat):
            out.append(pt.VarLenSparseFeat(
                pt.SparseFeat(c.name, c.vocabulary_size, c.embedding_dim,
                              embedding_name=c.embedding_name),
                maxlen=c.maxlen, combiner=c.combiner,
                length_name=c.length_name))
        elif isinstance(c, dt.SparseFeat):
            out.append(pt.SparseFeat(c.name, c.vocabulary_size,
                                     c.embedding_dim,
                                     embedding_name=c.embedding_name))
        else:
            out.append(pt.DenseFeat(c.name, c.dimension))
    return out


def case(name):
    """(x, y, JAX columns, a constructor ``make(models module, columns,
    **kw)``, batch size, loss) as ``tests/test_bf16_zoo.py`` sets the
    model up."""
    np.random.seed(7)
    if name in SINGLE_TASK:
        n_dense = 0 if name in ("AFM", "CCPM") else 2
        x, y, cols = get_test_data(sample_size=64, sparse_feature_num=2,
                                   dense_feature_num=n_dense,
                                   sequence_feature=("sum", "mean"))
        kw = {"seed": 5}
        if name == "CCPM":
            kw.update(conv_kernel_width=(3,), conv_filters=(4,))
        if name == "AFN":
            kw.update(ltl_hidden_size=8, afn_dnn_hidden_units=(8,))

        def make(models, c, **extra):
            cls = getattr(models, name)
            args = (c,) if name in ("PNN", "MLR") else (c, c)
            return cls(*args, **kw, **extra)
        return x, y, cols, make, 32, "binary_crossentropy"
    if name in MULTI_TASK:
        x, y, cols = get_mtl_test_data(sample_size=64, sparse_feature_num=2,
                                       dense_feature_num=2)

        def make(models, c, **extra):
            return getattr(models, name)(
                c, task_types=["binary", "binary"], task_names=["t0", "t1"],
                seed=5, **extra)
        return x, y, cols, make, 32, ["binary_crossentropy"] * 2
    if name == "DIN":
        from tests.models.DIN_test import get_xy_fd
        x, y, cols, behavior = get_xy_fd()
        kw = dict(dnn_hidden_units=(8,), seed=5)
    else:
        from tests.models.DIEN_test import get_xy_fd
        x, y, cols, behavior = get_xy_fd(use_neg=True)
        kw = dict(gru_type="AUGRU", use_negsampling=True,
                  dnn_hidden_units=(8,), seed=5)

    def make(models, c, **extra):
        return getattr(models, name)(c, behavior, **kw, **extra)
    return x, y, cols, make, 4, "binary_crossentropy"


def _trace(model, x, y, batch, loss):
    """predict; one adagrad step on the first batch; predict."""
    before = np.asarray(model.predict(x, batch), np.float64)
    model.compile("adagrad", loss)
    first = {k: v[:batch] for k, v in x.items()}
    model.fit(first, y[:batch], batch_size=batch, epochs=1, verbose=0)
    return before, np.asarray(model.predict(x, batch), np.float64)


def readings(name):
    """``{"jax_gap": (before, after), "port_gap": ..., "f32_gap": ...}``:
    the JAX package's bfloat16 against its float32, the port's bfloat16
    against the JAX package's bfloat16 and the port's float32 against the
    JAX package's float32, max abs over the predictions, before and after
    the step; and the spread of the predictions."""
    x, y, cols, make, batch, loss = case(name)
    saved = (dc_config.compute_dtype(), pt_config.compute_dtype())
    try:
        runs = {}
        weights = None
        for dtype in ("float32", "bfloat16"):
            dc_config.set_compute_dtype(dtype)
            jm = make(jzoo, cols)
            if weights is None:
                weights = jm.get_weights()
            else:
                jm.set_weights(weights)
            runs[dtype] = _trace(jm, x, y, batch, loss)
        port = {}
        for dtype in ("float32", "bfloat16"):
            pt_config.set_compute_dtype(dtype)
            pm = make(pmt if name in MULTI_TASK else pzoo,
                      port_columns(cols), device="cpu")
            load_jax_weights(pm, weights)
            port[dtype] = _trace(pm, x, y, batch, loss)
    finally:
        dc_config.set_compute_dtype(saved[0])
        pt_config.set_compute_dtype(saved[1])

    def gap(p, q):
        return tuple(float(np.abs(a - b).max()) for a, b in zip(p, q))
    j32, j16 = runs["float32"], runs["bfloat16"]
    return {"jax_gap": gap(j16, j32), "port_gap": gap(port["bfloat16"], j16),
            "f32_gap": gap(port["float32"], j32),
            "port_err": gap(port["bfloat16"], j32),
            "spread": float(j32[0].std())}


# (model, phase 0 before / 1 after the step) -> how a recorded miss is held
RECORDED = {("DCNMix", 0): "accuracy", ("MLR", 0): "accuracy",
            ("MLR", 1): "accuracy", ("PNN", 1): "reorder",
            ("MMOE", 1): "reorder", ("PLE", 1): "reorder"}


def reorder_witness(name):
    """The JAX package's bfloat16 predictions after the step on the batch
    as given, against after the step on its rows in reverse order (max
    abs)."""
    x, y, cols, make, batch, loss = case(name)
    saved = dc_config.compute_dtype()
    out = []
    try:
        dc_config.set_compute_dtype("bfloat16")
        weights = None
        for order in (np.arange(batch), np.arange(batch)[::-1]):
            jm = make(jzoo, cols)
            if weights is None:
                weights = jm.get_weights()
            jm.set_weights(weights)
            jm.compile("adagrad", loss)
            first = {k: v[:batch][order] for k, v in x.items()}
            jm.fit(first, y[:batch][order], batch_size=batch, epochs=1,
                   verbose=0, shuffle=False)
            out.append(np.asarray(jm.predict(x, batch), np.float64))
    finally:
        dc_config.set_compute_dtype(saved)
    return float(np.abs(out[0] - out[1]).max())


def check(name):
    """Hold the port's bfloat16 to the JAX package's within the JAX
    package's own bfloat16-against-float32 gap, before and after the
    step, or a recorded miss to what explains it; returns the readings."""
    r = readings(name)
    for phase in (0, 1):
        got, bound = r["port_gap"][phase], r["jax_gap"][phase]
        how = RECORDED.get((name, phase))
        if how is None:
            assert got <= bound, (name, phase, r)
        elif how == "accuracy":
            assert r["port_err"][phase] <= bound + r["f32_gap"][phase], (
                name, phase, r)
        else:
            r["witness"] = reorder_witness(name)
            assert got <= 2 * r["witness"], (name, phase, r)
    return r
