"""Dice and PReLU in the stacked expert towers of MMOE and PLE against
the JAX package (``deepctr_tpu/models/multitask/mmoe.py:22-30``, an
``nn.vmap`` of a DNN): ``Dice_<i>/alpha`` and ``Dice_<i>/bn/{mean,var}``
[K, units], ``PReLU_<i>/alpha`` [K, 1], each expert normalised by its
own batch statistics in training.  Predict, then one epoch of sgd or of
adagrad: losses, every weight, running statistic and optimizer state
(the helpers and tolerances of ``tests/test_torch_param_activations.py``).
"""

import numpy as np
import pytest

from deepctr_tpu_torch.utils.jax_weights import jax_to_state_dict
from tests.test_torch_multitask import BB, BR, mtl_data, pair
from tests.test_torch_param_activations import (ACTS, TOL, _assert_fit,
                                                _compile, _gap)
from tests.test_torch_train import _port_weights_of
from tests.test_torch_zoo import _restore_port_config  # noqa: F401


MTL = {"MMOE": (BR, ["binary_crossentropy", "mse"], dict(
    num_experts=3, expert_dnn_hidden_units=(8, 4), gate_dnn_hidden_units=(4,),
    tower_dnn_hidden_units=(4,))),
    "PLE": (BB, "binary_crossentropy", dict(
        num_levels=2, specific_expert_num=2, shared_expert_num=1,
        expert_dnn_hidden_units=(8, 4), gate_dnn_hidden_units=(4,),
        tower_dnn_hidden_units=(4,)))}


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("name", sorted(MTL))
def test_stacked_experts_with_dice_and_prelu_match_jax(name, activation,
                                                       opt):
    task_types, loss, kw = MTL[name]
    jcols, pcols, x, y = mtl_data(2, 2, 160, seed=11, task_types=task_types)
    jm, pm = pair(name, jcols, pcols, seed=3, task_types=task_types,
                  dnn_activation=activation, l2_reg_dnn=5e-3, **kw)
    experts = pm.expert_dnn if name == "MMOE" else pm.specific_expert_l0_t0
    K = kw["num_experts"] if name == "MMOE" else kw["specific_expert_num"]
    state = experts.state_dict()
    for i, u in enumerate(kw["expert_dnn_hidden_units"]):
        if activation == "dice":
            for leaf in ("alpha", "bn.mean", "bn.var"):
                assert tuple(state["Dice_%d.%s" % (i, leaf)].shape) == (K, u)
        else:
            assert tuple(state["PReLU_%d.alpha" % i].shape) == (K, 1)
    # predict from the shared weights, before the fit
    want = jm.predict(x, 64)
    assert want.std() > 0.02
    np.testing.assert_allclose(pm.predict(x, 64), want, rtol=0, atol=TOL)
    if (name, activation, opt) != ("PLE", "dice", "adagrad"):
        _assert_fit(jm, pm, x, y, opt, loss, 64)
    else:
        # One kernel entry of the level-1 shared expert parts by 5.2e-5:
        # its adagrad accumulator sums gradients that cancel through
        # Dice's batch statistics.  The JAX model against itself, with
        # each batch's rows in another order (the same batches and padding
        # row; the fit's shuffle applied to the arrays, shuffle off), parts
        # by 5.7e-5.  So the bound here is twice that witness.
        order = np.random.default_rng(jm.seed).permutation(len(y))
        rev = np.r_[order[:1], order[63:0:-1], order[127:63:-1],
                    order[128:]]
        start = jm.get_weights()
        _compile(jm, opt, loss)
        jm.fit({k: v[rev] for k, v in x.items()}, y[rev], batch_size=64,
               epochs=1, verbose=0, shuffle=False)
        witness = jax_to_state_dict(jm.get_weights(), pm.full_shapes())
        jm.set_weights(start)
        xs = {k: v[order] for k, v in x.items()}
        _assert_fit(jm, pm, xs, y[order], opt, loss, 64, shuffle=False,
                    tol=2 * _gap(_port_weights_of(jm, pm)[0], witness))
        assert _gap(_port_weights_of(jm, pm)[0], witness) < 1e-4
    if activation == "dice":
        # each expert's statistics moved, by its own batch's
        stats = experts.Dice_0.bn.mean.numpy()
        assert np.abs(stats).min() > 0
        assert not np.allclose(stats[0], stats[-1])
