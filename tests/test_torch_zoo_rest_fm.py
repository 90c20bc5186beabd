"""The port's IFM, DIFM and MLR against the JAX package's: ``predict`` for
every constructor case of their ``tests/models/<Model>_test.py``, with the
helpers and the tolerance of ``tests/test_torch_zoo_rest.py``; and MLR's
learner scores, which come from its *base* linear models
(``deepctr_tpu/models/mlr.py:6``, the LS-PLM paper)."""

import numpy as np
import pytest
import torch

from deepctr_tpu_torch.utils.jax_weights import load_jax_weights
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest import (CASES, case_ids, check_predict,
                                       mlr_data, pair)

LATER = [c for c in CASES if c[0] in ("IFM", "DIFM", "MLR")]


@pytest.mark.parametrize("i", range(len(LATER)), ids=case_ids(LATER))
def test_zoo_rest_predict_matches_jax(i):
    check_predict(LATER[i], i)


def test_mlr_learner_scores_come_from_the_base_linear_models():
    """With region and base columns apart, the prediction is
    ``sum_i softmax(region logits)_i * sigmoid(base logit_i)`` times the
    bias gate, from the port's own linear models, and the JAX model's is
    the same: zeroing the base models' weights leaves every learner score
    at 0.5 and the prediction at 0.5 times the bias gate, in both
    packages; zeroing the region models' instead changes the learner
    scores nowhere."""
    jcols, pcols, x, _ = mlr_data({"region": (2, 1, ()),
                                   "base": (2, 2, ()),
                                   "bias": (1, 0, ())}, 64, seed=3)
    jm, pm = pair("MLR", jcols, pcols, std=1.0, region_num=3)
    X = torch.from_numpy(pm._assemble_x(x))
    with torch.no_grad():
        region = torch.cat([m(X) for m in pm.region_linear_model], dim=-1)
        base = torch.cat([m(X) for m in pm.base_linear_model], dim=-1)
        gate = torch.sigmoid(pm.bias_linear(X))
    want = (torch.softmax(region, -1) * torch.sigmoid(base)).sum(
        -1, keepdim=True) * gate
    np.testing.assert_allclose(pm.predict(x), want.numpy(), atol=1e-6)
    np.testing.assert_allclose(jm.predict(x), want.numpy(), atol=1e-5)
    assert torch.sigmoid(base).std() > 0.05

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    def zeroed(prefix):
        weights = jm.get_weights()
        weights["params"] = {k: zeros(v) if k.startswith(prefix) else v
                             for k, v in weights["params"].items()}
        return weights
    jm.set_weights(zeroed("base_linear"))
    load_jax_weights(pm, zeroed("base_linear"))
    half = 0.5 * gate.numpy()
    np.testing.assert_allclose(pm.predict(x), half, atol=1e-6)
    np.testing.assert_allclose(jm.predict(x), half, atol=1e-6)
