"""The device-resident loop on the rest of the zoo against the JAX
package's: ``fit(model.assemble_device_input(x))`` against ``fit(x=
<jax.Array>)`` with ``validation_split``, then ``predict`` on a tensor,
for ONN (its shared tables on the sparse path, the pair tables dense),
CCPM, DIFM and MLR (the linear models' own tables).

On a CPU model the loop runs its captured body eagerly; ``chip_smoke.py``
holds the capture and its replays against the eager step on the card.
Both packages start from the same JAX weights (``tests/test_torch_zoo_
rest.py:pair``) with ``shuffle=False`` and N no multiple of the batch.
Tolerances: those of ``tests/test_torch_zoo_rest_train.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest_train import (TOL, assert_same_training,
                                             fit_pair)

B, EPOCHS = 64, 2


def device_fit_both(jm, pm, x, y, opt, loss, metrics, sparse=False):
    """Both models compiled alike and fit in their device loops; their
    histories."""
    for m in (jm, pm):
        m.compile(opt, loss, metrics=metrics,
                  sparse_table_updates=sparse)
    kw = dict(batch_size=B, epochs=EPOCHS, verbose=0, shuffle=False,
              validation_split=0.2)
    hj = jm.fit(jnp.asarray(jm._assemble_x(x)), y, **kw).history
    hp = pm.fit(pm.assemble_device_input(x), y, **kw).history
    assert set(hp) == set(hj)
    for k in hj:
        if k != "loss":
            np.testing.assert_allclose(hp[k], hj[k], rtol=TOL, err_msg=k)
    return hj, hp


@pytest.mark.parametrize("name, opt, sparse", [
    ("ONN", "adagrad", True), ("CCPM", "sgd", False),
    ("DIFM", "adagrad", False), ("MLR", "adagrad", False)])
def test_zoo_rest_device_fit_matches_the_jax_device_loop(name, opt, sparse):
    jm, pm, x, y = fit_pair(name, seed=3)
    hj, hp = device_fit_both(jm, pm, x, y, opt, "binary_crossentropy",
                             ["auc"], sparse)
    assert bool(pm._sparse_specs) == sparse
    assert ([s[0] for s in jm._sparse_specs]
            == [s[0] for s in pm._sparse_specs])
    assert_same_training(jm, pm, hj, hp)
    want = jm.predict(jnp.asarray(jm._assemble_x(x)), B)
    got = pm.predict(pm.assemble_device_input(x), B)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
