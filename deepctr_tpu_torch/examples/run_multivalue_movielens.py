"""MovieLens with the multi-valued ``genres`` feature, a mean-pooled
``VarLenSparseFeat`` (counterpart of
``examples/run_multivalue_movielens.py``).

    python -m deepctr_tpu_torch.examples.run_multivalue_movielens
"""

import numpy as np

from ..features import SparseFeat, VarLenSparseFeat
from ..models import DeepFM
from . import data_utils as D

SPARSE = ["movie_id", "user_id", "gender", "age", "occupation", "zip"]


def encode_genres(genres):
    """Each row's genres as ids from 1 (0 pads), in order of first
    appearance; returns the padded [n, maxlen] matrix and the vocabulary
    size."""
    key2index = {}
    rows = []
    for value in genres:
        ids = []
        for key in value.split("|"):
            ids.append(key2index.setdefault(key, len(key2index) + 1))
        rows.append(ids)
    maxlen = max(len(r) for r in rows)
    return D.pad_post(rows, maxlen), len(key2index) + 1


def main(epochs=10, device="cuda"):
    data = D.load_movielens_sample()
    for feat in SPARSE:
        data[feat] = D.label_encode(data[feat])
    genres, vocab = encode_genres(data["genres"])
    columns = ([SparseFeat(f, len(np.unique(data[f])), embedding_dim=4)
                for f in SPARSE]
               + [VarLenSparseFeat(SparseFeat("genres", vocabulary_size=vocab,
                                              embedding_dim=4),
                                   maxlen=genres.shape[1], combiner="mean")])
    x = {f: data[f] for f in SPARSE}
    x["genres"] = genres
    model = DeepFM(columns, columns, task="regression", device=device)
    model.compile("adam", "mse", metrics=["mse"])
    history = model.fit(x, data["rating"][:, None], batch_size=256,
                        epochs=epochs, verbose=2, validation_split=0.2)
    out = {k: round(float(v[-1]), 4) for k, v in history.history.items()}
    print(out)
    return out


if __name__ == "__main__":
    main()
