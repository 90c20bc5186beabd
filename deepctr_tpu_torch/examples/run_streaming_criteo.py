"""Out-of-core Criteo training through the streaming reader (counterpart
of ``examples/run_streaming_criteo.py``): the file streams through the
native parser (hashed categoricals, log1p dense) in chunks, so host memory
holds about one chunk whatever the file's size.

    python -m deepctr_tpu_torch.examples.run_streaming_criteo [path]

``CRITEO_VOCAB`` sets the hashing space (default 100,000) and ``BATCH``
the batch size (default 256); the default path is the in-repo sample.
"""

import os
import sys

from .. import config
from ..data import criteo_columns, criteo_stream
from ..models import DeepFM
from . import data_utils as D


def main(epochs=2, device="cuda", path=None):
    path = path or D.sample_path("criteo_sample.txt")
    vocab = int(os.environ.get("CRITEO_VOCAB", 100_000))
    saved = config.compute_dtype()
    config.set_compute_dtype("bfloat16")
    try:
        columns = criteo_columns(vocab_size=vocab, embedding_dim=16)
        model = DeepFM(columns, columns, dnn_hidden_units=(400, 400, 400),
                       task="binary", device=device)
        model.compile("adagrad", "binary_crossentropy", metrics=["logloss"])
        history = model.fit(criteo_stream(path, columns, chunk_rows=262144),
                            batch_size=int(os.environ.get("BATCH", 256)),
                            epochs=epochs, verbose=1)
    finally:
        config.set_compute_dtype(saved)
    out = {k: [round(float(v), 5) for v in vals]
           for k, vals in history.history.items()}
    print(out)
    return out


if __name__ == "__main__":
    main(path=sys.argv[1] if len(sys.argv) > 1 else None)
