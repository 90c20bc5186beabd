"""DeepFM (Guo et al., 2017, arXiv:1703.04247) in plain PyTorch, float32:

    logit = linear(x) + FM(e) + DNN(e, dense) @ w_out
    p     = sigmoid(logit + b)

over the weights the benchmark drew, by their names: each sparse field's
table ``embedding_dict.tables.<field>`` holds its E-wide embedding in the
first E columns and its linear weight in column E; the dense fields'
linear weights are ``linear_model.weight`` [n_dense, 1]; the DNN's layers
``dnn.dense_<i>``, its output ``dnn_linear.weight`` and the final bias
``out.bias``.  Imports torch and the references' shared helpers only.
"""

import torch

from portbench.reference._common import dnn, linear, lookup


def _fields(config):
    sparse = [c["name"] for c in config["columns"] if c["kind"] == "sparse"]
    dense = [c["name"] for c in config["columns"] if c["kind"] == "dense"]
    return sparse, dense


def forward(config, w, batch, precision="f32", training=True):
    """Click probabilities [B] of ``batch`` ({column: ids [B] int64 or
    values [B] float32}); no auxiliary loss (None)."""
    E = config["embedding_dim"]
    sparse, dense = _fields(config)
    rows = torch.stack([lookup(w["embedding_dict.tables." + n], batch[n],
                               precision) for n in sparse], 1)  # [B, F, E+1]
    emb, wide = rows[..., :E], rows[..., E]
    values = torch.stack([batch[n].float() for n in dense], 1)  # [B, 13]
    logit = wide.sum(1) + (values @ w["linear_model.weight"])[:, 0]
    square_of_sum = emb.sum(1) ** 2
    sum_of_square = (emb * emb).sum(1)
    logit = logit + 0.5 * (square_of_sum - sum_of_square).sum(1)
    x = torch.cat([emb.reshape(emb.shape[0], -1), values], 1)
    x = dnn(x, w, "dnn", len(config["dnn_hidden_units"]),
            lambda h, _: torch.relu(h), precision)
    logit = logit + linear(x, w["dnn_linear.weight"], None, precision)[:, 0]
    return torch.sigmoid(logit + w["out.bias"]), None


def matmul_flops(config, batch, training):
    """The forward's matrix-product operations an example (2 a
    multiply-add): the DNN tower and its output layer."""
    sparse, dense = _fields(config)
    dims = ([len(sparse) * config["embedding_dim"] + len(dense)]
            + list(config["dnn_hidden_units"]) + [1])
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))
