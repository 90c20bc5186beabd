"""Multi-task learning with MMOE on the byterec sample, finish and like
(counterpart of ``examples/run_multitask_learning.py``): label encoding,
min-max scaling, the first 80% of rows to train, then each task's test
LogLoss and AUC.

    python -m deepctr_tpu_torch.examples.run_multitask_learning
"""

import numpy as np

from ..features import DenseFeat, SparseFeat, get_feature_names
from ..models.multitask import MMOE
from ..utils.metrics import log_loss, roc_auc_score
from . import data_utils as D

SPARSE = ["uid", "user_city", "item_id", "author_id", "item_city",
          "channel", "music_id", "device"]
DENSE = ["duration_time"]
TARGET = ["finish", "like"]


def main(epochs=10, device="cuda"):
    data = D.load_byterec_sample()
    for feat in SPARSE:
        data[feat] = D.label_encode(data[feat])
    data.update(zip(DENSE, D.min_max_scale([data[f] for f in DENSE])))
    columns = ([SparseFeat(f, vocabulary_size=int(data[f].max()) + 1,
                           embedding_dim=4) for f in SPARSE]
               + [DenseFeat(f, 1) for f in DENSE])
    names = get_feature_names(columns)
    split = int(len(data["uid"]) * 0.8)
    train, test = D.take(data, slice(None, split)), D.take(
        data, slice(split, None))
    model = MMOE(columns, task_types=["binary", "binary"],
                 l2_reg_embedding=1e-5, task_names=TARGET, device=device)
    model.compile("adagrad", loss=["binary_crossentropy"] * 2,
                  metrics=["binary_crossentropy"])
    model.fit({n: train[n] for n in names},
              np.stack([train[t] for t in TARGET], axis=1), batch_size=32,
              epochs=epochs, verbose=2)
    pred = model.predict({n: test[n] for n in names}, 256)
    out = {}
    for i, t in enumerate(TARGET):
        y = np.asarray(test[t], np.float64)
        out["%s test LogLoss" % t] = round(log_loss(y, pred[:, i]), 4)
        out["%s test AUC" % t] = round(roc_auc_score(y, pred[:, i]), 4)
    print(out)
    return out


if __name__ == "__main__":
    main()
