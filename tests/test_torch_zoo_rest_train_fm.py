"""IFM, DIFM and MLR training on host arrays against the JAX package, with
the helpers and tolerances of ``tests/test_torch_zoo_rest_train.py``; and
MLR's L2: the engine's default rules name ``embedding_dict/`` and
``linear_model/``, which none of MLR's paths (``region_linear_<i>/...``)
match, so ``l2_reg_linear`` takes no effect in the JAX package, and none
in the port (ROADMAP.md section 3)."""

import numpy as np
import pytest

from deepctr_tpu_torch.models import MLR
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest_train import check_fit, fit_pair


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("name", ["IFM", "DIFM"])
def test_zoo_rest_fit_matches_jax(name, opt):
    check_fit(name, opt)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_mlr_fit_at_l2_reg_linear_matches_jax_and_takes_no_l2(opt):
    """At ``l2_reg_linear=0.1`` both packages' regularization terms are 0
    and the port's fit ends bit-equal to a fit of the same model at 0."""
    jm, pm, start = check_fit("MLR", opt)
    assert pm.get_regularization_loss() == 0.0
    assert jm.get_regularization_loss() == 0.0
    _, _, x, y = fit_pair("MLR")
    kw = dict(pm._init_kwargs, l2_reg_linear=0.0, device="cpu")
    twin = MLR(**kw)
    twin.set_weights(start)
    twin.compile(opt, "binary_crossentropy")
    twin.fit(x, y, batch_size=64, epochs=2, verbose=0)
    got, want = twin.get_weights(), pm.get_weights()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
