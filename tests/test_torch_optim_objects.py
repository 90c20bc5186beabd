"""``compile`` with a ``torch.optim.Optimizer`` (the port's counterpart of
an optax transform, ``models/basemodel.py:TorchOptimizer``) and
``fit(profile=...)``, on the CPU.

- ``optax.sgd``/``optax.adam`` in the JAX package against
  ``torch.optim.SGD``/``torch.optim.Adam`` in the port, from the same
  weights, on the host-array loop and the device-resident one: losses at
  1e-5 relative, weights at 1e-5 (float32 sums in another order), with L2
  on every group.
- JAX's errors and fallback (``tests/test_sparse_updates.py:295-305``):
  ``sparse_table_updates=True`` warns and trains the tables dense; a
  ``learning_rate`` beside an object raises; so does an optimizer that
  does not hold the model's parameters (built before ``.to()`` made new
  ones).
- The routes of the device loop: a graph where every parameter group has
  ``capturable=True``, else the same step eagerly (on the CPU every step
  runs eagerly; ``chip_smoke.py`` phase 31 holds both routes on the card).
- An exact resume of a torch optimizer's state through a checkpoint.
- ``fit(profile=dir)`` writes a trace there and changes no number."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepctr_tpu_torch.models import graphs
from tests.test_torch_checkpoint import _build, _xy, _assert_bit_equal
from tests.test_torch_train import (L2, _data, _pair, _port_weights_of,
                                    _record_jax, _record_port)

N, B, EPOCHS = 150, 32, 3


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_objects_match_optax(opt, loop):
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, N, np.random.default_rng(9))
    lr = 0.05 if opt == "sgd" else 1e-3
    jm.compile(getattr(optax, opt)(lr), "binary_crossentropy")
    cls = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt]
    pm.compile(cls(pm.parameters(), lr=lr), "binary_crossentropy")
    assert pm._optimizer_name is None and pm._sparse_specs == []
    if loop == "host":
        jl, pl = _record_jax(jm), _record_port(pm)
        hj = jm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0)
        hp = pm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    else:
        hj = jm.fit(jnp.asarray(jm._assemble_x(x)), y, batch_size=B,
                    epochs=EPOCHS, verbose=0, shuffle=False)
        hp = pm.fit(pm.assemble_device_input(x), y, batch_size=B,
                    epochs=EPOCHS, verbose=0, shuffle=False)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=1e-5)
    want, got = _port_weights_of(jm, pm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_sparse_true_with_an_optimizer_object_warns_and_falls_back():
    x, y = _xy(128)
    m = _build("sgd", "auto")
    with pytest.warns(UserWarning, match="falling back to DENSE"):
        m.compile(torch.optim.SGD(m.parameters(), lr=0.01),
                  "binary_crossentropy", sparse_table_updates=True)
    assert m._sparse_specs == []
    m.fit(x, y, batch_size=64, epochs=1, verbose=0)


def test_learning_rate_with_an_object_and_stale_optimizers_raise():
    x, y = _xy(64)
    m = _build("sgd", "auto")
    with pytest.raises(ValueError, match="learning_rate"):
        m.compile(torch.optim.SGD(m.parameters(), lr=0.01),
                  "binary_crossentropy", learning_rate=0.1)
    other = _build("sgd", "auto")
    m.compile(torch.optim.SGD(other.parameters(), lr=0.01),
              "binary_crossentropy")
    with pytest.raises(ValueError, match="not this model's parameters"):
        m.fit(x, y, batch_size=32, verbose=0)
    # a conversion that makes new parameter tensors leaves the optimizer
    # holding the old ones
    m.compile(torch.optim.Adam(m.parameters(), lr=0.01),
              "binary_crossentropy")
    m.fit(x, y, batch_size=32, verbose=0)
    saved = torch.__future__.get_overwrite_module_params_on_conversion()
    torch.__future__.set_overwrite_module_params_on_conversion(True)
    try:
        m.to("cpu")
    finally:
        torch.__future__.set_overwrite_module_params_on_conversion(saved)
    with pytest.raises(ValueError, match="before .to()"):
        m.fit(x, y, batch_size=32, verbose=0)
    m.compile(torch.optim.Adam(m.parameters(), lr=0.01),
              "binary_crossentropy")
    m.fit(x, y, batch_size=32, verbose=0)


def test_capturable_optimizer_objects_are_captured():
    """``capturable=True`` on every parameter group; torch refuses such a
    step on CPU tensors, so only the route is checked here."""
    m = _build("sgd", "auto")
    params = list(m.parameters())
    for groups, want in (
            ([{"params": params}], True),
            ([{"params": params[:2]}, {"params": params[2:],
                                       "capturable": False}], False)):
        m.compile(torch.optim.Adam(groups, lr=0.01, capturable=True),
                  "binary_crossentropy")
        assert m._dense_opt.capturable is want


@pytest.mark.parametrize("make, capturable", [
    (lambda ps: torch.optim.SGD(ps, lr=0.01), False),
    (lambda ps: torch.optim.Adagrad(ps, lr=0.01), False),
    (lambda ps: torch.optim.Adam(ps, lr=0.01), False),
    (None, True)])
def test_the_device_loop_route_of_each_optimizer(make, capturable):
    """A named optimizer is captured on the card, and so is an object with
    ``capturable=True``; the others run the same step eagerly, here as on
    the CPU.  Either route trains as the host loop does from the same
    weights."""
    x, y = _xy(96)
    ms = [_build("adagrad", "auto", dropout=0) for _ in range(2)]
    if make is not None:
        for m in ms:
            m.compile(make(m.parameters()), "binary_crossentropy")
    loop_model, host_model = ms
    loop_model.fit(loop_model.assemble_device_input(x), y, batch_size=32,
                   epochs=2, verbose=0, shuffle=False)
    loop = [g for k, g in loop_model._graphs.items() if k[0] == "fit"]
    assert isinstance(loop[0], graphs.StepGraph)
    assert loop[0].capturable == capturable
    host_model.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False)
    for k, v in host_model.get_weights().items():
        np.testing.assert_allclose(loop_model.get_weights()[k], v, rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_a_torch_optimizer_resumes_exactly(loop, tmp_path):
    x, y = _xy(192)

    def build():
        m = _build("sgd", "auto")
        m.compile(torch.optim.Adam(m.parameters(), lr=0.01),
                  "binary_crossentropy")
        return m

    ref, m, resumed = build(), build(), build()
    X = ref.assemble_device_input(x) if loop == "device" else x
    ref.fit(X, y, batch_size=64, epochs=2, verbose=0)
    m.fit(X, y, batch_size=64, epochs=1, verbose=0)
    m.save_checkpoint(str(tmp_path / "ckpt"))
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    _assert_bit_equal(resumed, m)
    resumed.fit(X, y, batch_size=64, epochs=2, initial_epoch=1, verbose=0)
    _assert_bit_equal(resumed, ref)
    assert all(len(st) == 3 for st in resumed._dense_opt.state)
    # another optimizer class, or other parameter groups, do not load
    other = _build("sgd", "auto")
    other.compile(torch.optim.Adagrad(other.parameters(), lr=0.01),
                  "binary_crossentropy")
    with pytest.raises(ValueError, match="does not match"):
        other.load_checkpoint(str(tmp_path / "ckpt"))
    params = list(other.parameters())
    other.compile(torch.optim.Adam([{"params": params[:2]},
                                    {"params": params[2:]}], lr=0.01),
                  "binary_crossentropy")
    with pytest.raises(ValueError, match="layout does not match"):
        other.load_checkpoint(str(tmp_path / "ckpt"))


@pytest.mark.parametrize("loop", ["host", "device"])
def test_fit_profile_writes_a_trace_and_changes_nothing(loop, tmp_path):
    x, y = _xy(128)
    hist = []
    for profile in (None, str(tmp_path / "trace")):
        m = _build("adagrad", True)
        X = m.assemble_device_input(x) if loop == "device" else x
        hist.append(m.fit(X, y, batch_size=32, epochs=2, verbose=0,
                          profile=profile).history)
    assert hist[0] == hist[1]
    traces = glob.glob(os.path.join(str(tmp_path / "trace"),
                                    "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0


def test_an_optimizer_object_keeps_its_own_state():
    """``compile`` and ``set_weights`` leave a torch optimizer's state as
    it is (Adagrad builds its accumulators when it is made); the named
    optimizers' state starts afresh, as the JAX package's."""
    x, y = _xy(64)
    m = _build("sgd", "auto")
    opt = torch.optim.Adagrad(m.parameters(), lr=0.01)
    m.compile(opt, "binary_crossentropy")
    assert all(len(st) == 2 for st in m._dense_opt.state)
    m.fit(x, y, batch_size=32, verbose=0)
    sums = [st[1].clone() for st in m._dense_opt.state]
    m.set_weights(m.get_weights())
    m.compile(opt, "binary_crossentropy")
    for a, b in zip(m._dense_opt.state, sums):
        assert torch.equal(a[1], b)
    m.fit(x, y, batch_size=32, verbose=0)
