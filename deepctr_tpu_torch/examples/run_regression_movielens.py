"""MovieLens rating regression with DeepFM (counterpart of
``examples/run_regression_movielens.py``): label encoding, a seeded
80/20 split, ``fit`` with a validation split, then the test MSE.

    python -m deepctr_tpu_torch.examples.run_regression_movielens
"""

import numpy as np

from ..features import SparseFeat, get_feature_names
from ..models import DeepFM
from ..utils.metrics import mean_squared_error
from . import data_utils as D

SPARSE = ["movie_id", "user_id", "gender", "age", "occupation", "zip"]


def main(epochs=10, device="cuda"):
    data = D.load_movielens_sample()
    for feat in SPARSE:
        data[feat] = D.label_encode(data[feat])
    columns = [SparseFeat(f, len(np.unique(data[f])), embedding_dim=4)
               for f in SPARSE]
    names = get_feature_names(columns + columns)
    train, test = (D.take(data, rows) for rows in D.train_test_split(
        len(data["rating"]), test_size=0.2, random_state=2020))
    model = DeepFM(columns, columns, task="regression", device=device)
    model.compile("adam", "mse", metrics=["mse"])
    model.fit({n: train[n] for n in names}, train["rating"][:, None],
              batch_size=256, epochs=epochs, verbose=2, validation_split=0.2)
    pred = model.predict({n: test[n] for n in names}, batch_size=256)
    out = {"test MSE": round(mean_squared_error(test["rating"], pred), 4)}
    print(out)
    return out


if __name__ == "__main__":
    main()
