"""DIEN with negative sampling and AUGRU (counterpart of
``examples/run_dien.py``): four users' histories of items and categories,
with negative histories for the auxiliary loss.

    python -m deepctr_tpu_torch.examples.run_dien
"""

import numpy as np

from ..features import (DenseFeat, SparseFeat, VarLenSparseFeat,
                        get_feature_names)
from ..models import DIEN


def get_xy_fd(use_neg=False):
    columns = [SparseFeat("user", 4, embedding_dim=4),
               SparseFeat("gender", 2, embedding_dim=4),
               SparseFeat("item_id", 3 + 1, embedding_dim=8),
               SparseFeat("cate_id", 2 + 1, embedding_dim=4),
               DenseFeat("pay_score", 1)]
    prefixes = ("hist_", "neg_hist_") if use_neg else ("hist_",)
    for prefix in prefixes:
        columns += [
            VarLenSparseFeat(SparseFeat(prefix + "item_id",
                                        vocabulary_size=3 + 1,
                                        embedding_dim=8,
                                        embedding_name="item_id"),
                             maxlen=4, length_name="seq_length"),
            VarLenSparseFeat(SparseFeat(prefix + "cate_id",
                                        vocabulary_size=2 + 1,
                                        embedding_dim=4,
                                        embedding_name="cate_id"),
                             maxlen=4, length_name="seq_length")]
    items = np.array([[1, 2, 3, 0], [1, 2, 3, 0], [1, 2, 0, 0],
                      [1, 2, 0, 0]])
    cates = np.array([[1, 1, 2, 0], [2, 1, 1, 0], [2, 1, 0, 0],
                      [1, 2, 0, 0]])
    feature_dict = {
        "user": np.array([0, 1, 2, 3]), "gender": np.array([0, 1, 0, 1]),
        "item_id": np.array([1, 2, 3, 2]), "cate_id": np.array([1, 2, 1, 2]),
        "pay_score": np.array([0.1, 0.2, 0.3, 0.2]),
        "seq_length": np.array([3, 3, 2, 2])}
    for prefix in prefixes:
        feature_dict[prefix + "item_id"] = items
        feature_dict[prefix + "cate_id"] = cates
    x = {name: feature_dict[name] for name in get_feature_names(columns)}
    return x, np.array([1, 0, 1, 0]), columns, ["item_id", "cate_id"]


def main(epochs=10, device="cuda"):
    x, y, columns, behavior = get_xy_fd(use_neg=True)
    model = DIEN(columns, behavior, gru_type="AUGRU", use_negsampling=True,
                 dnn_hidden_units=(4, 4, 4), dnn_dropout=0.6, device=device)
    model.compile("adam", "binary_crossentropy",
                  metrics=["binary_crossentropy", "auc"])
    history = model.fit(x, y[:, None], batch_size=2, epochs=epochs,
                        verbose=2, validation_split=0.0)
    out = {k: round(float(v[-1]), 4) for k, v in history.history.items()}
    out["predictions"] = [round(float(p), 4) for p in model.predict(x, 4)]
    print(out)
    return out


if __name__ == "__main__":
    main()
