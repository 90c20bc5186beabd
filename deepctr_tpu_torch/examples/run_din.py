"""DIN over a behaviour sequence (counterpart of ``examples/run_din.py``):
three users' histories of items and their genders.

    python -m deepctr_tpu_torch.examples.run_din
"""

import numpy as np

from ..features import (DenseFeat, SparseFeat, VarLenSparseFeat,
                        get_feature_names)
from ..models import DIN


def get_xy_fd():
    columns = [SparseFeat("user", 3, embedding_dim=8),
               SparseFeat("gender", 2, embedding_dim=8),
               SparseFeat("item", 3 + 1, embedding_dim=8),
               SparseFeat("item_gender", 2 + 1, embedding_dim=8),
               DenseFeat("score", 1)]
    columns += [
        VarLenSparseFeat(SparseFeat("hist_item", 3 + 1, embedding_dim=8),
                         4, length_name="seq_length"),
        VarLenSparseFeat(SparseFeat("hist_item_gender", 2 + 1,
                                    embedding_dim=8),
                         4, length_name="seq_length")]
    behavior = ["item", "item_gender"]
    feature_dict = {
        "user": np.array([0, 1, 2]), "gender": np.array([0, 1, 0]),
        "item": np.array([1, 2, 3]), "item_gender": np.array([1, 2, 1]),
        "score": np.array([0.1, 0.2, 0.3]),
        "hist_item": np.array([[1, 2, 3, 0], [1, 2, 3, 0], [1, 2, 0, 0]]),
        "hist_item_gender": np.array([[1, 1, 2, 0], [2, 1, 1, 0],
                                      [2, 1, 0, 0]]),
        "seq_length": np.array([3, 3, 2])}
    x = {name: feature_dict[name] for name in get_feature_names(columns)}
    return x, np.array([1, 0, 1]), columns, behavior


def main(epochs=10, device="cuda"):
    x, y, columns, behavior = get_xy_fd()
    model = DIN(columns, behavior, att_weight_normalization=True,
                device=device)
    model.compile("adagrad", "binary_crossentropy",
                  metrics=["binary_crossentropy"])
    history = model.fit(x, y[:, None], batch_size=3, epochs=epochs,
                        verbose=2, validation_split=0.0)
    out = {k: round(float(v[-1]), 4) for k, v in history.history.items()}
    out["predictions"] = [round(float(p), 4) for p in model.predict(x, 3)]
    print(out)
    return out


if __name__ == "__main__":
    main()
