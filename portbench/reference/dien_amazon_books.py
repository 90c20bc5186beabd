"""DIEN (Zhou et al., 2019, arXiv:1809.03672) in plain PyTorch, float32,
as the configuration states it: AUGRU interest evolution, the auxiliary
loss over negative samples, an attention MLP with sigmoid activations and
softmax weights, a DNN with Dice.

For a sample with target item i (category c), history h_1..h_L of items
(categories) and, in training, negative items n_1..n_L:

    e_t = [E_item[h_t], E_cate[cat(h_t)]]             (H = 2E wide)
    s_t = GRU(e_t, s_{t-1})                 t <= L    interest extractor
    aux = -sum_{t<L} [log D([s_t, e_{t+1}]) + log(1 - D([s_t, ne_{t+1}]))]
          / (2 * #pairs of the batch)                 D: sigmoid MLP
    a_t = softmax_t(MLP([q, s_t, q - s_t, q * s_t]))  q = [E_item[i], E_cate[c]]
    o_t = AUGRU(s_t, o_{t-1}; a_t)                    update gate * a_t
    p   = sigmoid(DNN_dice([o_L, E_user[u], E_item[i], E_cate[c]]) w + b)

GRU gates in torch's order (r, z, n), h_0 = 0, steps past L keep the state.
Dice: ``alpha * (1 - s) * x + s * x``, ``s = sigmoid((x - mean) /
sqrt(var + 1e-8))``, batch moments in training, the running ones
(``...bn.mean``, ``...bn.var``) at inference.  Weights are read by the
names the benchmark drew them under.  Imports torch and the references'
shared helpers only.
"""

import torch

from portbench.reference._common import dnn, linear, lookup


def _gru(x, mask, w, prefix, precision, att=None):
    """Masked GRU (AUGRU where ``att`` [B, T] is given) over x [B, T, I]:
    (outputs [B, T, H], zero past each row's length; final state)."""
    B, T, _ = x.shape
    w_hh = w[prefix + ".weight_hh"]
    H = w_hh.shape[1]
    gi = linear(x.reshape(B * T, -1), w[prefix + ".weight_ih"],
                w[prefix + ".bias_ih"], precision).reshape(B, T, 3 * H)
    h = x.new_zeros(B, H)
    outs = []
    for t in range(T):
        gh = linear(h, w_hh, w[prefix + ".bias_hh"], precision)
        g = gi[:, t]
        r = torch.sigmoid(g[:, :H] + gh[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        if att is not None:
            z = att[:, t:t + 1] * z
            h_new = (1.0 - z) * h + z * n
        else:
            h_new = (1.0 - z) * n + z * h
        m = mask[:, t:t + 1].float()
        outs.append(m * h_new)
        h = h + m * (h_new - h)
    return torch.stack(outs, 1), h


def _dice(x, w, prefix, training):
    if training:
        mean = x.mean(0)
        var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
    else:
        mean, var = w[prefix + ".bn.mean"], w[prefix + ".bn.var"]
    s = torch.sigmoid((x - mean) * torch.rsqrt(var + 1e-8))
    return w[prefix + ".alpha"] * (1.0 - s) * x + s * x


def _emb(w, table, ids, precision):
    return lookup(w["embedding_dict.tables." + table], ids, precision)


def forward(config, w, batch, precision="f32", training=True):
    """(click probabilities [B], the auxiliary loss scaled by alpha in
    training, else None) of ``batch`` ({column: ids int64 [B] or
    [B, maxlen], ``seq_length`` [B]})."""
    items, cates = config["history_feature_list"]

    def pair(item_col, cate_col):
        return torch.cat([_emb(w, items, batch[item_col], precision),
                          _emb(w, cates, batch[cate_col], precision)], -1)

    q = pair(items, cates)                                   # [B, H]
    keys = pair("hist_" + items, "hist_" + cates)            # [B, T, H]
    length = batch["seq_length"].long()
    T = keys.shape[1]
    pos = torch.arange(T, device=keys.device)[None, :]
    mask = pos < length[:, None]
    states, _ = _gru(keys, mask, w, "interest_extractor.gru", precision)
    aux = None
    if training and config["use_negsampling"]:
        neg = pair("neg_hist_" + items, "neg_hist_" + cates)
        pair_mask = (pos[:, :-1] < (length - 1)[:, None]).float()

        def aux_net(x):
            # three sigmoid layers of 100, 50 and 1 units
            return dnn(x, w, "interest_extractor.auxiliary_net", 3,
                       lambda h, _: torch.sigmoid(h), precision)[..., 0]
        s = states[:, :-1]
        click = torch.clamp(aux_net(torch.cat([s, keys[:, 1:]], -1)),
                            1e-7, 1 - 1e-7)
        noclick = torch.clamp(aux_net(torch.cat([s, neg[:, 1:]], -1)),
                              1e-7, 1 - 1e-7)
        terms = -(torch.log(click) + torch.log(1.0 - noclick)) * pair_mask
        aux = config["alpha"] * terms.sum() / (
            2.0 * torch.clamp_min(pair_mask.sum(), 1.0))
    att_in = torch.cat([q[:, None].expand_as(states), states,
                        q[:, None] - states, q[:, None] * states], -1)
    prefix = "interest_evolution.attention.local_att"
    hidden = dnn(att_in, w, prefix + ".dnn", len(config["att_hidden_units"]),
                 lambda h, _: torch.sigmoid(h), precision)
    scores = linear(hidden, w[prefix + ".dense.weight"],
                    w[prefix + ".dense.bias"], precision)[..., 0]   # [B, T]
    scores = torch.where(mask, scores,
                         torch.full_like(scores, -2.0 ** 32 + 1))
    att = torch.softmax(scores, -1)
    _, final = _gru(states, mask, w, "interest_evolution.evolution",
                    precision, att=att)
    final = torch.where((length > 0)[:, None], final,
                        torch.zeros_like(final))
    sparse = [c["name"] for c in config["columns"] if c["kind"] == "sparse"]
    x = torch.cat([final] + [_emb(w, n, batch[n], precision)
                             for n in sparse], -1)
    x = dnn(x, w, "dnn", len(config["dnn_hidden_units"]),
            lambda h, i: _dice(h, w, "dnn.Dice_%d" % i, training), precision)
    logit = linear(x, w["dnn_linear.weight"], None, precision)[:, 0]
    return torch.sigmoid(logit + w["out.bias"]), aux


def matmul_flops(config, batch, training):
    """The forward's matrix-product operations an example (2 a
    multiply-add), over the steps inside each history: both GRUs' input
    and recurrent products, the attention MLP, the DNN and, in training,
    the auxiliary network's two passes a pair of steps."""
    H = config["hidden_size"]
    L = float(batch["seq_length"].float().mean())
    att = [4 * H] + list(config["att_hidden_units"]) + [1]
    sparse = [c for c in config["columns"] if c["kind"] == "sparse"]
    dims = ([H + sum(c["dim"] for c in sparse)]
            + list(config["dnn_hidden_units"]) + [1])

    def mlp(d):
        return sum(2 * a * b for a, b in zip(d[:-1], d[1:]))
    flops = 2 * (2 * L * (H * 3 * H + H * 3 * H))      # two GRUs
    flops += L * mlp(att) + mlp(dims)
    if training and config["use_negsampling"]:
        flops += 2 * max(L - 1.0, 0.0) * mlp([2 * H, 100, 50, 1])
    return float(flops)
