"""xDeepFM (Lian et al., 2018, arXiv:1803.05170) in plain PyTorch, float32:

    logit = linear(x) + CIN(e) @ w_cin + DNN(e, dense) @ w_out
    p     = sigmoid(logit + b)

The CIN as the paper writes it, with the field embeddings x0 [B, F, D]
(D = E) and the hidden maps x^{k-1} [B, H_{k-1}, D], x^0 = x0:

    z[b, h, f, d]   = x^{k-1}[b, h, d] * x0[b, f, d]
    x^k[b, o, d]    = sum_{h, f} W_k[o, h, f] z[b, h, f, d] + c_k[o]

``W_k`` is ``cin.conv_w_<k>`` [O_k, H_{k-1} * F] read as [O_k, H_{k-1}, F]
(h-major, f-minor) and ``c_k`` is ``cin.conv_b_<k>``.  Every map of a
layer is the next layer's input and goes to the output, with no
activation; a configuration with ``cin_split_half`` or a
``cin_activation`` other than ``linear`` (DeepCTR's variants) is refused.
The output maps are summed over D, concatenated and mixed by
``cin_linear.weight`` [1, featuremap].

Over the weights the benchmark drew, by their names: each sparse field's
table ``embedding_dict.tables.<field>`` holds its E-wide embedding in the
first E columns and its linear weight in column E; the dense fields'
linear weights are ``linear_model.weight`` [n_dense, 1]; the DNN's layers
``dnn.dense_<i>``, its output ``dnn_linear.weight`` and the final bias
``out.bias``.  Imports torch and the references' shared helpers only.

Departures from the paper, each as the port and DeepCTR have it:

- each CIN layer adds a bias a map (``conv_b``), where the paper's layer
  equation has none;
- the linear part's weights of the sparse fields sit in the tables'
  column E (the fused wide column), which is the same arithmetic.
"""

import torch

from portbench.reference._common import dnn, linear, lookup, operand


def _fields(config):
    sparse = [c["name"] for c in config["columns"] if c["kind"] == "sparse"]
    dense = [c["name"] for c in config["columns"] if c["kind"] == "dense"]
    return sparse, dense


def _cin_layers(config):
    """``[(H_{k-1}, O_k)]`` of the CIN's layers."""
    if config["cin_split_half"] or config["cin_activation"] != "linear":
        raise ValueError("the reference's CIN is the paper's: no split_half "
                         "and no activation")
    F = len(_fields(config)[0])
    sizes = config["cin_layer_size"]
    return list(zip([F] + sizes[:-1], sizes))


def cin(config, w, x0, precision):
    """The CIN over field embeddings x0 [B, F, D] -> [B, featuremap]."""
    B, F, D = x0.shape
    x, finals = x0, []
    for k, (H, O) in enumerate(_cin_layers(config)):
        z = torch.einsum("bhd,bfd->bhfd", operand(x, precision),
                         operand(x0, precision))
        W = w["cin.conv_w_%d" % k].reshape(O, H, F)
        xk = torch.einsum("ohf,bhfd->bod", operand(W, precision),
                          operand(z, precision))
        x = xk + w["cin.conv_b_%d" % k][None, :, None]
        finals.append(x.sum(2))
    return torch.cat(finals, 1)


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
    logit = logit + linear(cin(config, w, emb, precision),
                           w["cin_linear.weight"], None, precision)[:, 0]
    x = torch.cat([emb.reshape(emb.shape[0], -1), values], 1)
    x = dnn(x, w, "dnn", len(config["dnn_hidden_units"]),
            lambda h, _: torch.relu(h), precision)
    logit = logit + linear(x, w["dnn_linear.weight"], None, precision)[:, 0]
    return torch.sigmoid(logit + w["out.bias"]), None


def matmul_flops(config, batch, training):
    """The forward's matrix-product operations an example (2 a
    multiply-add): each CIN layer's mix (D * H_{k-1} * F * O_k; the outer
    product's multiplies are not counted), the CIN's output layer, the DNN
    tower and its output layer."""
    sparse, dense = _fields(config)
    F, D = len(sparse), config["embedding_dim"]
    layers = _cin_layers(config)
    flops = sum(2 * D * H * F * O for H, O in layers)
    flops += 2 * sum(O for _, O in layers)
    dims = ([F * D + len(dense)] + list(config["dnn_hidden_units"]) + [1])
    return float(flops + sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))
