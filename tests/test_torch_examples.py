"""The example recipes on the port (``deepctr_tpu_torch/examples/``): its
loader against the JAX examples' (``examples/data_utils.py`` with pandas
and sklearn's ``LabelEncoder``, ``MinMaxScaler`` and
``train_test_split``) on the three in-repo samples, array for array; each
recipe's ``main(epochs=1, device="cpu")``; and the rule that a recipe
asks for CUDA unless given a device."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split
from sklearn.preprocessing import LabelEncoder, MinMaxScaler

from deepctr_tpu_torch.examples import data_utils as D
from deepctr_tpu_torch.examples import (run_classification_criteo,
                                        run_dien, run_din,
                                        run_multitask_learning,
                                        run_multivalue_movielens,
                                        run_regression_movielens,
                                        run_streaming_criteo)

RECIPES = [run_classification_criteo, run_regression_movielens,
           run_multivalue_movielens, run_multitask_learning, run_din,
           run_dien, run_streaming_criteo]


def _jax_loader():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "data_utils.py")
    spec = importlib.util.spec_from_file_location("jax_example_data", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_criteo_sample_loads_and_encodes_as_pandas_and_sklearn():
    df = _jax_loader().load_criteo_sample()
    sparse, dense = run_classification_criteo.SPARSE, \
        run_classification_criteo.DENSE
    df[sparse] = df[sparse].fillna("-1")
    df[dense] = df[dense].fillna(0)
    for feat in sparse:
        df[feat] = LabelEncoder().fit_transform(df[feat])
    df[dense] = MinMaxScaler((0, 1)).fit_transform(df[dense])
    data, columns = run_classification_criteo.load()
    assert set(data) == set(df.columns)
    for name in ["label"] + sparse + dense:
        np.testing.assert_array_equal(data[name], df[name].values,
                                      err_msg=name)
    assert [c.vocabulary_size for c in columns[:26]] == [
        int(df[f].max()) + 1 for f in sparse]
    train, test = train_test_split(df, test_size=0.2, random_state=2020)
    rows = D.train_test_split(len(df), test_size=0.2, random_state=2020)
    np.testing.assert_array_equal(rows[0], train.index.values)
    np.testing.assert_array_equal(rows[1], test.index.values)


def test_the_movielens_sample_loads_and_encodes_as_pandas_and_sklearn():
    df = _jax_loader().load_movielens_sample()
    data = D.load_movielens_sample()
    assert list(data) == list(df.columns)
    for name in run_regression_movielens.SPARSE + ["rating"]:
        np.testing.assert_array_equal(
            D.label_encode(data[name]),
            LabelEncoder().fit_transform(df[name]), err_msg=name)
    assert list(data["title"]) == list(df["title"])   # quoted commas
    genres, vocab = run_multivalue_movielens.encode_genres(data["genres"])
    key2index = {}
    want = [[key2index.setdefault(k, len(key2index) + 1)
             for k in v.split("|")] for v in df["genres"].values]
    assert vocab == len(key2index) + 1
    for row, ids in zip(genres, want):
        assert list(row[:len(ids)]) == ids and not row[len(ids):].any()


def test_the_byterec_sample_loads_and_encodes_as_pandas_and_sklearn():
    df = _jax_loader().load_byterec_sample()
    data = D.load_byterec_sample()
    assert list(data) == list(df.columns)
    for name in data:
        np.testing.assert_array_equal(data[name], df[name].values)
    for name in run_multitask_learning.SPARSE:
        np.testing.assert_array_equal(
            D.label_encode(data[name]),
            LabelEncoder().fit_transform(df[name]), err_msg=name)
    np.testing.assert_array_equal(
        D.min_max_scale([data["duration_time"]])[0],
        MinMaxScaler((0, 1)).fit_transform(df[["duration_time"]])[:, 0])


@pytest.mark.parametrize("recipe", RECIPES,
                         ids=[r.__name__.split(".")[-1] for r in RECIPES])
def test_each_recipe_runs_one_epoch_on_the_cpu(recipe):
    out = recipe.main(epochs=1, device="cpu")
    assert out
    for key, value in out.items():
        values = np.asarray(value, np.float64).reshape(-1)
        # a batch of one class has no AUC (NaN, as sklearn's)
        assert np.isfinite(values).all() or key == "auc", (key, value)


def test_a_recipe_asks_for_cuda_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for recipe in RECIPES:
        with pytest.raises(RuntimeError, match="CUDA"):
            recipe.main(epochs=1)
