"""Dice and PReLU inside the CIN and the stacked expert towers, against
the JAX package.

The CIN builds one activation before its layer loop and calls it at every
layer without ``training`` (``deepctr_tpu/layers/interaction.py:165``,
``:178``): one ``Dice_0`` or ``PReLU_0`` shared by the layers, Dice always
normalising with its running statistics.  The stacked experts vmap a DNN
(``deepctr_tpu/models/multitask/mmoe.py:22-30``): ``Dice_<i>/alpha`` and
``Dice_<i>/bn/{mean,var}`` [K, units], ``PReLU_<i>/alpha`` [K, 1], each
expert normalised by its own batch statistics in training.

Held here: the CIN layer (float32 forward and gradients, and its running
statistics after a training apply), the CIN in each of the
``set_cin_dtype`` modes at bfloat16 compute, the layer sizes under which
a Dice CIN raises in both packages; xDeepFM with each activation:
predict, one epoch of sgd and one of adagrad, every weight, running
statistic and optimizer state; the new leaves' paths.  MMOE and PLE in
``tests/test_torch_param_activations_mtl.py``.

Tolerances.  float32: 1e-5 (another order of sums), relative above 1 for
the weights and optimizer states (a PReLU slope sums its gradient over
every negative value of the batch and reaches 20 in one sgd epoch, where
float32 rounding alone is 1e-6 absolute).  bfloat16: the CIN mode test's (``tests/test_torch_
cin.py:MODE_TOL``), relative to the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
from deepctr_tpu.layers import CIN as JCIN
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import CIN as PCIN
from deepctr_tpu_torch.utils.jax_weights import jax_path, port_key
from tests.test_torch_cin import _restore_cin_dtype  # noqa: F401
from tests.test_torch_cin import MODE_TOL, _np
from tests.test_torch_device_loop import _jax_states, _port_states
from tests.test_torch_train import (_port_weights_of, _record_jax,
                                    _record_port)
from tests.test_torch_xdeepfm import _data as xdeepfm_data
from tests.test_torch_xdeepfm import _pair as xdeepfm_pair
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest_train import TOL

ACTS = ("dice", "prelu")


def _cin_pair(activation, layer_size=(8, 8), F=5, seed=0):
    """A JAX CIN with its weights, biases, activation parameters and Dice
    statistics drawn from a numpy seed, and the port's layer holding
    them."""
    jl = JCIN(field_size=F, layer_size=layer_size, activation=activation)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (16, F, 4)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.array, jl.init(jax.random.PRNGKey(seed), x))
    params = dict(variables["params"])
    for i in range(len(layer_size)):
        params["conv_b_%d" % i] = rng.normal(
            0, 0.3, layer_size[i]).astype(np.float32)
    if activation == "dice":
        params["Dice_0"] = {"alpha": rng.normal(0, 0.5, (layer_size[0],))
                            .astype(np.float32)}
    else:
        params["PReLU_0"] = {"alpha": np.array([0.3], np.float32)}
    if activation == "dice":
        stats = {"Dice_0": {"bn": {
            "mean": rng.normal(0, 0.3, (layer_size[0],)).astype(np.float32),
            "var": rng.uniform(0.5, 2, (layer_size[0],)).astype(np.float32)}}}
    else:
        stats = {}
    pl = PCIN(F, layer_size, activation=activation, device="cpu")
    flat = {}
    for tree in (params, stats):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = port_key("/".join(k.key for k in path))
            flat[key] = torch.from_numpy(np.asarray(v))
    pl.load_state_dict(flat)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jl, variables, pl, x


@pytest.mark.parametrize("activation", ACTS)
def test_cin_with_dice_and_prelu_matches_jax(activation):
    """float32 forward and every gradient; a training apply (mutable
    statistics) moves no Dice statistic in either package."""
    jl, variables, pl, x = _cin_pair(activation)
    names = {"dice": {"Dice_0.alpha", "Dice_0.bn.mean", "Dice_0.bn.var"},
             "prelu": {"PReLU_0.alpha"}}[activation]
    assert names < set(pl.state_dict())
    assert tuple(pl.state_dict()[sorted(names)[0]].shape) == (
        (8,) if activation == "dice" else (1,))

    def f(p, xx):
        out, upd = jl.apply(dict(variables, params=p), xx, training=True,
                            mutable=["batch_stats"])
        return out, upd
    out, vjp, upd = jax.vjp(f, variables["params"], jnp.asarray(x),
                            has_aux=True)
    g = np.random.default_rng(1).normal(0, 1, out.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = pl(tx, training=True)
    np.testing.assert_allclose(_np(got), _np(out), rtol=0, atol=TOL)
    got.backward(torch.from_numpy(g))
    for path, want in jax.tree_util.tree_flatten_with_path(gp)[0]:
        key = port_key("/".join(k.key for k in path))
        grad = dict(pl.named_parameters())[key].grad
        np.testing.assert_allclose(_np(grad), _np(want), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(_np(tx.grad), _np(gx), rtol=0, atol=TOL)
    if activation == "dice":
        for name in ("mean", "var"):
            np.testing.assert_array_equal(
                _np(upd["batch_stats"]["Dice_0"]["bn"][name]),
                variables["batch_stats"]["Dice_0"]["bn"][name])
            np.testing.assert_array_equal(
                getattr(pl.Dice_0.bn, name).numpy(),
                variables["batch_stats"]["Dice_0"]["bn"][name])


def test_a_training_apply_leaves_the_cin_dice_statistics_at_0_and_1():
    """From their initial values, as the JAX layer leaves them
    (ROADMAP section 3)."""
    jl = JCIN(field_size=5, layer_size=(8, 8), activation="dice")
    x = np.random.default_rng(2).normal(0, 1, (16, 5, 4)).astype(np.float32)
    variables = jl.init(jax.random.PRNGKey(0), x)
    _, upd = jl.apply(variables, x, training=True, mutable=["batch_stats"])
    pl = PCIN(5, (8, 8), activation="dice", device="cpu")
    pl(torch.from_numpy(x), training=True)
    for name, want in (("mean", 0.0), ("var", 1.0)):
        np.testing.assert_array_equal(
            np.asarray(upd["batch_stats"]["Dice_0"]["bn"][name]), want)
        np.testing.assert_array_equal(getattr(pl.Dice_0.bn, name).numpy(),
                                      want)


def test_dice_cin_of_unequal_layer_sizes_raises_and_prelu_runs():
    x = np.random.default_rng(3).normal(0, 1, (16, 5, 4)).astype(np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        JCIN(field_size=5, layer_size=(16, 8), activation="dice").init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match=r"\(16, 8\)"):
        PCIN(5, (16, 8), activation="dice", device="cpu")
    jl, variables, pl, x = _cin_pair("prelu", layer_size=(16, 8), seed=4)
    assert tuple(pl.PReLU_0.alpha.shape) == (1,)
    want = jl.apply(variables, x)
    with torch.no_grad():
        got = pl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("mode", sorted(MODE_TOL))
def test_cin_modes_take_dice_and_prelu_in_bf16_training(
        mode, activation, monkeypatch, _restore_cin_dtype):
    """bfloat16 compute, training, each ``set_cin_dtype`` mode against the
    JAX layer under ``DEEPCTR_CIN_DTYPE``: the activation takes the maps
    in the mode's carried dtype and returns float32 in both packages (the
    float32 parameters promote), so the output is float32 in every mode;
    forward and gradients at the mode's tolerance; inference too."""
    monkeypatch.setenv("DEEPCTR_CIN_DTYPE", mode)
    dt.set_compute_dtype("bfloat16")   # restored by the conftest
    pt_config.set_compute_dtype("bfloat16")
    pt_config.set_cin_dtype(mode)
    jl, variables, pl, x = _cin_pair(activation, layer_size=(16, 16), F=26,
                                     seed=7)

    def f(p, xx):
        return jl.apply(dict(variables, params=p), xx, training=True,
                        mutable=["batch_stats"])[0]
    out, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    g = np.random.default_rng(8).normal(0, 1, out.shape).astype(np.float32)
    gp, _ = vjp(jnp.asarray(g, out.dtype))
    got = pl(torch.from_numpy(x), training=True)
    assert out.dtype == jnp.float32 and got.dtype == torch.float32
    got.backward(torch.from_numpy(g))
    fwd_tol, grad_tol = MODE_TOL[mode]
    want = _np(out)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=fwd_tol * np.abs(want).max())
    for path, w in jax.tree_util.tree_flatten_with_path(gp)[0]:
        key = port_key("/".join(k.key for k in path))
        w = _np(w)
        np.testing.assert_allclose(
            _np(dict(pl.named_parameters())[key].grad), w, rtol=0,
            atol=grad_tol * np.abs(w).max(), err_msg=key)
    want = _np(jl.apply(variables, x))
    with torch.no_grad():
        got = pl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=MODE_TOL["bf16"][0] * np.abs(want).max())


def _compile(m, opt, loss):
    # sgd at 1e-3: at the default 1e-2 a regression task diverges
    m.compile(opt, loss, **({"learning_rate": 1e-3} if opt == "sgd" else {}))


def _assert_fit(jm, pm, x, y, opt, loss, batch_size, shuffle=True,
                tol=TOL):
    for m in (jm, pm):
        _compile(m, opt, loss)
    jl, pl = _record_jax(jm), _record_port(pm)
    hj, hp = (m.fit(x, y, batch_size=batch_size, epochs=1, verbose=0,
                    shuffle=shuffle) for m in (jm, pm))
    assert len(jl) == len(pl) > 1
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    # (the JAX model's history keeps an earlier fit's epoch)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"][-1:],
                               rtol=TOL)
    for want, got in ((_port_weights_of(jm, pm)),
                      (_jax_states(jm), _port_states(pm))):
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=str(k))
    np.testing.assert_allclose(pm.predict(x, batch_size),
                               jm.predict(x, batch_size), rtol=0, atol=TOL)


@pytest.mark.parametrize("opt", ["predict", "sgd", "adagrad"])
@pytest.mark.parametrize("activation", ACTS)
def test_xdeepfm_with_a_cin_activation_matches_jax(activation, opt):
    jm, pm, cols = xdeepfm_pair(dnn_hidden_units=(8,), cin_layer_size=(8, 8),
                                cin_activation=activation, l2_reg_cin=4e-3)
    name = {"dice": "Dice_0", "prelu": "PReLU_0"}[activation]
    assert hasattr(pm.cin, name)
    x, y = xdeepfm_data(cols, 160, np.random.default_rng(4))
    if opt == "predict":
        want = jm.predict(x, 64)
        assert want.std() > 0.05
        np.testing.assert_allclose(pm.predict(x, 64), want, rtol=0, atol=TOL)
        return
    _assert_fit(jm, pm, x, y, opt, "binary_crossentropy", 64)


def _gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def test_the_new_leaves_map_both_ways():
    for path in ("cin/Dice_0/alpha", "cin/Dice_0/bn/mean", "cin/PReLU_0/alpha",
                 "expert_dnn/Dice_1/alpha", "expert_dnn/Dice_1/bn/var",
                 "shared_expert_l0/PReLU_0/alpha",
                 "specific_expert_l1_t0/Dice_0/bn/mean"):
        assert jax_path(port_key(path)) == path
        assert port_key(path) == path.replace("/", ".")
