"""The port's dropout (``layers.core.Dropout``) against flax's
``nn.Dropout`` semantics and the JAX package, on the CPU.

- Inference with dropout configured: ``predict`` and ``evaluate`` of the
  port equal the JAX package's at 1e-5 (float32; another order of sums)
  for the DNN (DeepFM's ``dnn_dropout``), NFM (``bi_dropout`` and
  ``dnn_dropout``) and AFM (``afm_dropout``): dropout is the identity
  there.
- Rate 0 in training: the fit trajectory equals the JAX package's (the
  bounds of ``tests/test_torch_zoo_train.py``).
- Training statistics: a kept value is ``x / (1 - rate)`` exactly, the
  keep fraction lies within 5 sigma of ``1 - rate``, rate 1 gives zeros.
  torch cannot draw flax's bits, so the masks themselves are not compared
  with JAX.
- The masks are a function of (seed, epoch, step) in both loops: two fits
  from the same weights draw the same masks, every step new ones, and a
  ``fit(initial_epoch=1)`` after ``load_checkpoint`` draws the masks of
  the uninterrupted run's second epoch."""

import numpy as np
import pytest
import torch

import deepctr_tpu_torch as pt
from deepctr_tpu_torch.layers import core as pcore
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from tests.test_torch_train import _data, _pair
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo import pair
from tests.test_torch_zoo_train import check_fit, fit_columns, fit_data

import deepctr_tpu as dt


@pytest.mark.parametrize("name, kw", [
    ("DeepFM", dict(dnn_dropout=0.5)),
    ("NFM", dict(dnn_hidden_units=(16, 8), dnn_dropout=0.3,
                 bi_dropout=0.5)),
    ("AFM", dict(attention_factor=6, afm_dropout=0.5))])
def test_inference_with_dropout_matches_jax(name, kw):
    if name == "DeepFM":
        jm, pm, cols = _pair(**kw)
        x, y = _data(cols, 200, np.random.default_rng(2))
    else:
        n_dense = 0 if name == "AFM" else 2
        jm, pm = pair(name, fit_columns(dt, n_dense), fit_columns(pt, n_dense),
                      **kw)
        x, y = fit_data(fit_columns(pt, n_dense), 200, seed=2)
    assert pm._has_dropout()
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), rtol=0,
                               atol=1e-5)
    metrics = ["binary_crossentropy", "auc"]
    for m in (jm, pm):
        m.compile("sgd", "binary_crossentropy", metrics=metrics)
    ej, ep = jm.evaluate(x, y, 64), pm.evaluate(x, y, 64)
    assert set(ep) == set(ej) == set(metrics)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=1e-5, abs=1e-6)


def test_rate_zero_trains_as_the_jax_package(monkeypatch):
    """NFM with both dropouts at 0 written out: the dropout modules sit
    in the path and are the identity, so the trajectory is the JAX
    package's."""
    from tests import test_torch_zoo_train as zt
    monkeypatch.setitem(zt.FITS, "NFM", dict(zt.FITS["NFM"], dnn_dropout=0,
                                             bi_dropout=0))
    check_fit("NFM", "sgd", 1e-5)


def _layer_draws(rate, shape=(4000, 50), seed=0):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) + 3
    layer = pcore.Dropout(rate)
    with pcore.dropout_generator(torch.Generator().manual_seed(seed)):
        return x, layer(x, training=True)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_training_keeps_one_minus_rate_scaled_by_its_inverse(rate):
    x, out = _layer_draws(rate)
    kept = out != 0
    n = kept.numel()
    keep = 1.0 - rate
    sigma = np.sqrt(n * keep * (1 - keep))
    assert abs(int(kept.sum()) - n * keep) <= 5 * sigma
    torch.testing.assert_close(out[kept], x[kept] / keep, rtol=0, atol=0)


def test_rate_one_gives_zeros_and_inference_is_the_identity():
    x, out = _layer_draws(1.0)
    assert not out.any()
    layer = pcore.Dropout(0.5)
    assert layer(x, training=False) is x
    assert pcore.Dropout(0.0)(x, training=True) is x
    # a training forward with dropout outside a train step has no
    # generator to draw from
    with pytest.raises(RuntimeError, match="dropout generator"):
        layer(x, training=True)
    with pytest.raises(ValueError):
        pcore.Dropout(-0.1)


def test_bfloat16_dropout_scales_in_the_compute_dtype():
    x = torch.randn(64, 32).to(torch.bfloat16)
    with pcore.dropout_generator(torch.Generator().manual_seed(0)):
        out = pcore.Dropout(0.5)(x, training=True)
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(out[kept], x[kept] / 0.5)


def _masks_of_fits(monkeypatch, fits):
    """The masks each call of ``fits`` draws: a list a call, each mask as
    a numpy bool array."""
    drawn = []
    keep_mask = pcore.Dropout.keep_mask

    def record(self, x):
        mask = keep_mask(self, x)
        drawn[-1].append(mask.numpy().copy())
        return mask
    monkeypatch.setattr(pcore.Dropout, "keep_mask", record)
    for fit in fits:
        drawn.append([])
        fit()
    return drawn


def _model():
    cols = [pt.SparseFeat("c0", 50, 4), pt.SparseFeat("c1", 30, 4),
            pt.DenseFeat("d0", 1)]
    m = PDeepFM(cols, cols, dnn_hidden_units=(8, 8), dnn_dropout=0.5, seed=5,
                device="cpu")
    m.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    return m


@pytest.mark.parametrize("loop", ["host", "device"])
def test_masks_are_a_function_of_seed_epoch_and_step(loop, monkeypatch,
                                                      tmp_path):
    rng = np.random.default_rng(0)
    x = {"c0": rng.integers(0, 50, 192), "c1": rng.integers(0, 30, 192),
         "d0": rng.random(192)}
    y = rng.integers(0, 2, 192).astype(np.float32)
    a, b, c = _model(), _model(), _model()
    inputs = {m: (m.assemble_device_input(x) if loop == "device" else x)
              for m in (a, b, c)}

    def fit(m, **kw):
        return lambda: m.fit(inputs[m], y, batch_size=64, verbose=0, **kw)

    def save_and_load():
        b.save_checkpoint(str(tmp_path / "ckpt"))
        c.load_checkpoint(str(tmp_path / "ckpt"))

    two, one, _, resumed = _masks_of_fits(monkeypatch, [
        fit(a, epochs=2), fit(b, epochs=1), save_and_load,
        fit(c, epochs=2, initial_epoch=1)])
    per_step = 2                    # the DNN's two layers
    steps = 3
    assert len(two) == 2 * steps * per_step
    # the same masks in the first epoch from the same seed, and in the
    # resumed second epoch
    for got, want in zip(one + resumed, two):
        np.testing.assert_array_equal(got, want)
    # every step draws new masks
    firsts = [two[i * per_step] for i in range(2 * steps)]
    for i in range(len(firsts)):
        for j in range(i):
            assert not np.array_equal(firsts[i], firsts[j]), (i, j)
    for k, v in a.get_weights().items():
        np.testing.assert_array_equal(c.get_weights()[k], v, err_msg=k)
