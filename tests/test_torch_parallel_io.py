"""What leaves a mesh: ``serving.export_predict`` of a model on a ``(1,
2)`` mesh with row-sharded tables (every rank exports, rank 0 saves; the
artifact is one-device and holds every table whole, as the JAX package's
``jax.export`` of a model on a mesh is), ``save``/``load_model`` of such a
model, and checkpoints of a ``torch.optim`` optimizer over row-sharded
tables (the state of each table gathered whole into a file of the layout
a run without a mesh writes; each rank loads its block).

The ranks run ``tests/torch_mesh_workers.py`` on gloo; the references
here: the artifact loaded in this process without a mesh within 1e-5 of
the mesh's ``predict`` and of the JAX package's export of the same model
on the same mesh (the ``sgd`` leg of ``tests/test_torch_parallel.py``:
its weights, data and fit); a resumed fit on the mesh bit-equal to the
uninterrupted one, and the same checkpoint resumed without a mesh within
1e-4 after the next epoch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
from deepctr_tpu import models as jmodels
from deepctr_tpu import serving as jserving
from deepctr_tpu.parallel import make_mesh as jax_mesh
import deepctr_tpu_torch as pt
from deepctr_tpu_torch import serving
from deepctr_tpu_torch.tools.multiprocess_sim import spawn
from deepctr_tpu_torch.utils.serialization import CHECKPOINT_FILE

from tests import torch_mesh_workers as W
from tests.test_torch_parallel import DATA, LEGS, WORKERS, weights

SHAPE = (1, 2)
LEG = LEGS["sgd"]


def _jax_exported(X):
    """The JAX package's artifact of the leg's model on a (1, 2) mesh,
    from the same weights and fit, called on ``X``."""
    mesh = jax_mesh(SHAPE, devices=jax.devices()[:2])
    m = W.make_model(dt, jmodels, LEG, seed=3, mesh=mesh,
                     shard_embeddings=True)
    m.set_weights(weights(LEG["weights"]))
    m.compile(LEG["optimizer"], W.loss_of(LEG))
    W.fit_leg(m, LEG, *DATA[LEG["data"]])
    exported = jserving.export_predict(m)
    return np.asarray(exported.call(jnp.asarray(X)), np.float64)


def test_export_on_a_mesh_is_one_device_and_whole(tmp_path):
    """Both ranks export; rank 0 alone writes the artifact (and the
    ``save`` file); loaded here without a mesh, the artifact predicts as
    the mesh and as JAX's artifact, within 1e-5, and holds each table
    whole though each rank held half of c0 and c1; ``load_model`` of the
    saved model builds it on one process."""
    x, y = DATA[LEG["data"]]
    out = spawn(WORKERS + ":export_on_mesh", 2, str(tmp_path / "run"),
                {"mesh_shape": SHAPE, "leg": LEG, "x": x, "y": y,
                 "weights": weights(LEG["weights"]),
                 "directory": str(tmp_path)}, timeout=180, device="cpu")
    assert (tmp_path / "rank0.pt2").exists()
    assert not (tmp_path / "rank1.pt2").exists()
    assert (tmp_path / "model0.pt").exists()
    assert not (tmp_path / "model1.pt").exists()
    assert out[0]["blocks"] == {"embedding_dict/c0": (0, 32),
                                "embedding_dict/c1": (0, 16)}
    assert out[1]["blocks"] == {"embedding_dict/c0": (32, 64),
                                "embedding_dict/c1": (16, 32)}
    for r in out:
        assert r["shapes"]["model.embedding_dict.tables.c0"] == (64, 9)
        assert r["shapes"]["model.embedding_dict.tables.c1"] == (32, 9)
        np.testing.assert_array_equal(r["exported"], out[0]["exported"])
        np.testing.assert_array_equal(r["pred"], out[0]["pred"])
    pred = out[0]["pred"]
    loaded = serving.load_exported(str(tmp_path / "rank0.pt2"))
    model = pt.load_model(str(tmp_path / "model0.pt"))
    assert model.mesh is None and not model._shards
    X = model._assemble_x(x)
    got = loaded.call(X).numpy().astype(np.float64)
    assert got.shape == pred.shape
    np.testing.assert_allclose(got, pred, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[0]["exported"], pred, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, _jax_exported(X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(model.predict(x, LEG["batch"]), pred, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("optimizer", ["Adagrad", "Adam"])
def test_torch_optim_checkpoint_over_sharded_tables(tmp_path, optimizer):
    """A ``torch.optim`` optimizer over a (1, 2) mesh's row-sharded
    tables: the checkpoint after epoch 1 holds each table's state whole,
    in the layout (and within 1e-6 of the values) of the same epoch
    without a mesh; resumed on the mesh, epoch 2 is bit-equal to the
    uninterrupted run, and resumed without a mesh within 1e-4 of it."""
    x, y = DATA[LEG["data"]]
    ckpt = tmp_path / "ckpt"
    out = spawn(WORKERS + ":optim_checkpoint", 2, str(tmp_path / "run"),
                {"mesh_shape": SHAPE, "leg": LEG, "x": x, "y": y,
                 "directory": str(ckpt), "optimizer": optimizer},
                timeout=180, device="cpu")
    for r in out:
        assert r["blocks"]
        whole, resumed = r["whole"], r["resumed"]
        assert resumed["loss"] == whole["loss"]
        np.testing.assert_array_equal(resumed["pred"], whole["pred"])
        for k, v in whole["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][k], v)
        for a, b in zip(resumed["state"], whole["state"]):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(whole["pred"], out[0]["whole"]["pred"])

    def build():
        model = W.make_model(pt, pt.models, LEG, seed=3, device="cpu")
        model.compile(W.optimizer_object(optimizer, model), W.loss_of(LEG))
        return model
    one = build()
    one.fit(x, y, batch_size=LEG["batch"], epochs=1, verbose=0)
    one.save_checkpoint(str(tmp_path / "one"))
    saved = torch.load(ckpt / CHECKPOINT_FILE, weights_only=True)
    ref = torch.load(tmp_path / "one" / CHECKPOINT_FILE, weights_only=True)
    got_state = saved["optimizer"]["torch_state"]["state"]
    ref_state = ref["optimizer"]["torch_state"]["state"]
    assert sorted(got_state) == sorted(ref_state)
    for i, st in ref_state.items():
        assert sorted(got_state[i]) == sorted(st)
        for k, v in st.items():
            assert got_state[i][k].shape == v.shape, (i, k)
            torch.testing.assert_close(got_state[i][k], v, rtol=0,
                                       atol=1e-6)
    # the tables' state is whole in the file: c0's 64 rows, c1's 32
    rows = {v.shape[0] for st in got_state.values() for v in st.values()
            if v.dim() == 2 and v.shape[1] == 9}
    assert rows == {32, 64}
    again = build()
    again.load_checkpoint(str(ckpt))
    hist = again.fit(x, y, batch_size=LEG["batch"], epochs=2,
                     initial_epoch=1, verbose=0)
    want = out[0]["whole"]
    np.testing.assert_allclose(again.predict(x, LEG["batch"]), want["pred"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(hist.history["loss"][-1], want["loss"],
                               rtol=1e-4)
