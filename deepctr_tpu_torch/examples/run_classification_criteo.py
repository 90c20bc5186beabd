"""Criteo binary classification with DeepFM (counterpart of
``examples/run_classification_criteo.py``): missing values filled, label
encoding and min-max scaling, a seeded 80/20 split, ``fit`` with a
validation split, then the test LogLoss and AUC.

    python -m deepctr_tpu_torch.examples.run_classification_criteo
"""

import numpy as np

from ..features import DenseFeat, SparseFeat, get_feature_names
from ..models import DeepFM
from ..utils.metrics import log_loss, roc_auc_score
from . import data_utils as D

SPARSE = ["C" + str(i) for i in range(1, 27)]
DENSE = ["I" + str(i) for i in range(1, 14)]


def load():
    """The encoded sample and its feature columns."""
    data = D.load_criteo_sample()
    for feat in SPARSE:
        data[feat] = D.label_encode(D.fillna(data[feat], "-1"))
    scaled = D.min_max_scale([D.fillna(data[f], 0) for f in DENSE])
    data.update(zip(DENSE, scaled))
    columns = ([SparseFeat(f, vocabulary_size=int(data[f].max()) + 1,
                           embedding_dim=4) for f in SPARSE]
               + [DenseFeat(f, 1) for f in DENSE])
    return data, columns


def main(epochs=10, device="cuda"):
    data, columns = load()
    names = get_feature_names(columns + columns)
    train, test = (D.take(data, rows) for rows in D.train_test_split(
        len(data["label"]), test_size=0.2, random_state=2020))
    model = DeepFM(columns, columns, task="binary", l2_reg_embedding=1e-5,
                   device=device)
    model.compile("adagrad", "binary_crossentropy",
                  metrics=["binary_crossentropy", "auc"])
    model.fit({n: train[n] for n in names}, train["label"][:, None],
              batch_size=32, epochs=epochs, verbose=2, validation_split=0.2)
    pred = model.predict({n: test[n] for n in names}, 256)
    y = np.asarray(test["label"], np.float64)
    out = {"test LogLoss": round(log_loss(y, pred), 4),
           "test AUC": round(roc_auc_score(y, pred), 4)}
    print(out)
    return out


if __name__ == "__main__":
    main()
