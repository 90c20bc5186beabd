"""The port's device-resident loop on zoo models against the JAX
package's: ``fit(x=<tensor>)`` against ``fit(x=<jax.Array>)`` for DCN
(its tables on the sparse path, adagrad), AutoInt (dense tables under
adagrad, sparse under sgd) and PNN (no linear part, both product layers),
then ``predict`` on a tensor.

On a CPU model the loop runs its captured body eagerly; ``chip_smoke.py``
holds the capture and its replays against the eager step on the card.
Both packages start from the same JAX weights (``tests/test_torch_zoo.py``)
with ``shuffle=False`` and N no multiple of the batch.  Bounds: those of
``tests/test_torch_device_loop.py::test_device_fit_matches_the_jax_device_loop``
(per-epoch losses at rtol 1e-5, every weight at atol 1e-6, every dense and
sparse optimizer state at 1e-6, relative above 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_device_loop import _assert_same_training, _fit_both
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_train import fit_data, fit_pair

N, B, EPOCHS = 300, 64, 3


@pytest.mark.parametrize("name, opt, sparse", [
    ("DCN", "adagrad", True), ("AutoInt", "adagrad", False),
    ("AutoInt", "sgd", True), ("PNN", "adagrad", True)])
def test_zoo_device_fit_matches_the_jax_device_loop(name, opt, sparse):
    jm, pm, cols = fit_pair(name, seed=3)
    x, y = fit_data(cols, N, seed=21)
    hj, hp = _fit_both(jm, pm, x, y, opt, epochs=EPOCHS, batch_size=B,
                       sparse_table_updates=sparse)
    assert bool(pm._sparse_specs) == sparse
    assert ([s[0] for s in jm._sparse_specs]
            == [s[0] for s in pm._sparse_specs])
    _assert_same_training(jm, pm, hj, hp)
    assert pm._dense_opt.count == EPOCHS * (-(-N // B))
    want = jm.predict(jnp.asarray(jm._assemble_x(x)), B)
    got = pm.predict(pm.assemble_device_input(x), B)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
