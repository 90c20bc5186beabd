"""The reference's training steps: the plain model's loss, its gradients
by autograd, and the optimizer's arithmetic, in float32, from the weights
the benchmark drew.

The step follows the training semantics the configuration states (those of
the JAX package, which the port keeps): the data loss is the sum of the
batch's cross-entropy; the L2 of a parameter the configuration's ``l2``
rules name is part of the loss, but for a table on the sparse path, whose
L2 is added to the gradient of the rows the batch touches (the batch's ids
and row 0), and only those rows step; the optimizer is adagrad
(``a += g^2; w -= lr g / (sqrt(a) + 1e-10)``) or adam (b1 0.9, b2 0.999,
eps 1e-8, bias corrections ``1 - b^t`` in float32, a sparse table's rows
stepped with the step's count).

``fault="half_batch"`` plants a fault a check must catch in the reference
put in the program's place: the loss of the first half of each batch,
doubled (half left out, the mean taken over the rest).
"""

import re

import numpy as np
import torch

from portbench.reference._common import bce_sum

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_EPS = 1e-10


def l2_of(config, name, width):
    """The per-column L2 vector [width] of parameter ``name`` by the
    configuration's rules: ``deep`` columns are the first
    ``embedding_dim``, ``wide`` the rest, ``all`` every column."""
    vec = torch.zeros(width, dtype=torch.float64)
    E = config.get("embedding_dim", width)
    for pattern, key, part in config["l2"]:
        if not re.search(pattern, name):
            continue
        lam = float(config[key])
        if part == "deep":
            vec[:min(E, width)] += lam
        elif part == "wide":
            vec[min(E, width):] += lam
        else:
            vec += lam
    return vec.float()


def _bias_corrections(t):
    tf, one = np.float32(t), np.float32(1.0)
    return (float(one - np.float32(ADAM_B1) ** tf),
            float(one - np.float32(ADAM_B2) ** tf))


def train(module, config, w0, layout, batches, labels, sparse, steps=3,
          precision="f32", fault=None):
    """Run ``steps`` training steps of the reference ``module`` from the
    weights ``w0`` ({name: tensor}; not changed) on ``batches`` ({column:
    tensor}) and ``labels``.  ``layout``: ``[(name, shape, is a
    parameter)]``; ``sparse``: {table name: [its id columns]}, the tables
    on the sparse path.

    Returns ``{"losses": [total loss of each step], "grad_norms": {name:
    norm of the first step's gradient as the optimizer took it},
    "change_norms": {name: norm of the change after the steps}}``."""
    params = {n: w0[n].detach().clone().requires_grad_()
              for n, _, is_param in layout if is_param}
    buffers = {n: w0[n] for n, _, is_param in layout if not is_param}
    l2 = {n: l2_of(config, n, p.shape[-1] if p.dim() > 1 else 1).to(p.device)
          for n, p in params.items()}
    opt = config["optimizer"]
    n_state = {"adagrad": 1, "adam": 2}[opt]
    state = {n: [torch.zeros_like(p) for _ in range(n_state)]
             for n, p in params.items()}
    lr = float(config["learning_rate"])
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for t, (batch, y) in enumerate(zip(batches, labels)):
        if t == steps:
            break
        weights = dict(buffers, **params)
        p, aux = module.forward(config, weights, batch, precision,
                                training=True)
        if fault == "half_batch":
            half = p.shape[0] // 2
            data = 2.0 * bce_sum(p[:half], y[:half])
        else:
            data = bce_sum(p, y)
        total = data if aux is None else data + aux
        for n, w in params.items():
            if n in sparse or not bool((l2[n] > 0).any()):
                continue
            total = total + torch.sum(l2[n] * w * w)
        names = list(params)
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        out["losses"].append(float(total.detach()))
        bc = _bias_corrections(t + 1)
        with torch.no_grad():
            for n, g in zip(names, grads):
                w = params[n]
                if g is None:
                    g = torch.zeros_like(w)
                rows = None
                if n in sparse:
                    ids = torch.cat([batch[c].reshape(-1) for c in sparse[n]]
                                    + [torch.zeros(1, dtype=torch.int64,
                                                   device=w.device)])
                    rows = torch.unique(ids)
                    g = g[rows] + 2.0 * l2[n] * w[rows]
                if t == 0:
                    out["grad_norms"][n] = float(g.double().norm())
                _step(opt, w, state[n], g, rows, lr, bc)
    for n, w in params.items():
        out["change_norms"][n] = float((w.detach() - w0[n]).double().norm())
    return out


def _step(opt, w, st, g, rows, lr, bc):
    """The optimizer's step of ``w`` (at ``rows`` only, where given)."""
    def take(a):
        return a if rows is None else a[rows]

    def put(a, v):
        if rows is None:
            a.copy_(v)
        else:
            a[rows] = v
    wv = take(w)
    if opt == "adagrad":
        acc = take(st[0]) + g * g
        put(st[0], acc)
        put(w, wv - lr * g / (torch.sqrt(acc) + ADAGRAD_EPS))
    else:
        m = ADAM_B1 * take(st[0]) + (1 - ADAM_B1) * g
        v = ADAM_B2 * take(st[1]) + (1 - ADAM_B2) * (g * g)
        put(st[0], m)
        put(st[1], v)
        put(w, wv - lr * ((m / bc[0]) / (torch.sqrt(v / bc[1]) + ADAM_EPS)))
