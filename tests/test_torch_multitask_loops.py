"""The device-resident loop on the multi-task models against the JAX
package's: ``fit(model.assemble_device_input(x), y)`` with ``y`` [N,
n_tasks] and a loss list against ``fit(x=<jax.Array>)``, with
``validation_split``, whose ``val_<task>_<metric>`` keys and values are
the JAX package's; then ``predict`` on a tensor ([N, n_tasks]).  ESMM runs
with its tables on the sparse path.

Helpers and tolerances: ``tests/test_torch_zoo_rest_loops.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_multitask_train import fit_pair
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest_loops import B, device_fit_both
from tests.test_torch_zoo_rest_train import TOL, assert_same_training


@pytest.mark.parametrize("name, opt, sparse", [
    ("SharedBottom", "sgd", False), ("ESMM", "adagrad", True),
    ("MMOE", "adagrad", False), ("PLE", "sgd", False)])
def test_multitask_device_fit_matches_the_jax_device_loop(name, opt,
                                                          sparse):
    jm, pm, x, y, loss, metrics = fit_pair(name, seed=2)
    hj, hp = device_fit_both(jm, pm, x, y, opt, loss, metrics, sparse)
    assert {"val_%s_%s" % (t, m) for t in pm.task_names
            for m in metrics} < set(hp)
    assert bool(pm._sparse_specs) == sparse
    assert_same_training(jm, pm, hj, hp)
    want = jm.predict(jnp.asarray(jm._assemble_x(x)), B)
    got = pm.predict(pm.assemble_device_input(x), B)
    assert got.shape == (len(y), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
