"""What the multi-task models share: their task checks, their stacked
expert towers and their per-task heads.

Counterpart of ``deepctr_tpu/models/multitask/utils.py`` and of
``deepctr_tpu/models/multitask/mmoe.py:22-30`` (``stacked_dnn``).
"""

import torch
from torch import nn

from ... import config
from ...layers.activation import BatchNorm, activation_layer
from ...layers.core import DNN, Dropout, PredictionLayer, _dense


def validate_tasks(task_types, task_names, dnn_feature_columns,
                   exactly_two=False, binary_only=False):
    """Raise ValueError where the JAX package's models do; returns the
    number of tasks."""
    num_tasks = len(task_names)
    if exactly_two:
        if num_tasks != 2:
            raise ValueError("the length of task_names must be equal to 2")
    elif num_tasks <= 1:
        raise ValueError("num_tasks must be greater than 1")
    if len(dnn_feature_columns) == 0:
        raise ValueError("dnn_feature_columns is null!")
    if len(task_types) != num_tasks:
        raise ValueError("num_tasks must be equal to the length of "
                         "task_types")
    for task_type in task_types:
        if binary_only:
            if task_type != "binary":
                raise ValueError("task must be binary in ESMM, {} is "
                                 "illegal".format(task_type))
        elif task_type not in ["binary", "regression"]:
            raise ValueError("task must be binary or regression, {} is "
                             "illegal".format(task_type))
    return num_tasks


class StackedDense(nn.Module):
    """``num`` dense layers side by side: ``kernel`` [num, in, out] (the
    JAX package's vmapped layout, kept as it is) from normal(init_std),
    ``bias`` [num, out] from zeros.  [B, in] (every layer the same input)
    or [num, B, in] -> [num, B, out], one batched product in the compute
    dtype."""

    def __init__(self, num, in_features, features, init_std, device=None,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            num, in_features, features, device=device).normal_(
                0.0, init_std, generator=generator))
        self.bias = nn.Parameter(torch.zeros(num, features, device=device))

    def forward(self, x):
        ct = config.compute_dtype()
        return (torch.matmul(x.to(ct), self.kernel.to(ct))
                + self.bias.to(ct)[:, None, :])


class StackedDNN(nn.Module):
    """``num`` DNN towers of one shape on one input, as the JAX package's
    ``stacked_dnn`` vmaps ``DNN`` (parameters and batch statistics with a
    leading ``num`` axis): ``dense_<i>`` (:class:`StackedDense`), with
    ``use_bn`` ``bn_<i>`` (:class:`BatchNorm` of [num, units] over the
    batch alone, each tower its own statistics), the activation, and
    dropout drawing one mask over every tower's values.  [B, D] ->
    [B, num, units[-1]].  Dice and PReLU are one module a layer,
    ``Dice_<i>``/``PReLU_<i>``, with the expert axis: Dice's ``alpha`` and
    ``bn.{mean,var}`` [num, units] (each tower normalised by its own batch
    statistics in training), PReLU's ``alpha`` [num, 1]."""

    def __init__(self, num, inputs_dim, hidden_units, activation="relu",
                 dropout_rate=0.0, use_bn=False, init_std=1e-4, device=None,
                 generator=None):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        self.hidden_units = tuple(hidden_units)
        self.use_bn = use_bn
        self.dropout = Dropout(dropout_rate, batch_axis=1)  # [num, B, u]
        self.acts = []
        dims = (inputs_dim,) + self.hidden_units
        for i, units in enumerate(self.hidden_units):
            self.add_module("dense_%d" % i, StackedDense(
                num, dims[i], units, init_std, device, generator))
            if use_bn:
                self.add_module("bn_%d" % i, BatchNorm(
                    (num, units), epsilon=1e-5, axis=(0, 2), device=device))
            act = activation_layer(activation, hidden_size=units,
                                   experts=num, device=device)
            if isinstance(act, nn.Module):
                self.add_module("%s_%d" % (type(act).__name__, i), act)
            self.acts.append(act)

    def forward(self, x, training=False):
        for i, act in enumerate(self.acts):
            x = getattr(self, "dense_%d" % i)(x)
            if self.use_bn:
                x = getattr(self, "bn_%d" % i)(x, training)
            x = self.dropout(act(x, training), training)
        return x.transpose(0, 1)


def gate_mix(score_logits, experts):
    """``softmax(score_logits)`` over the experts [B, K] mixes ``experts``
    [B, K, dim] -> [B, dim]."""
    score = torch.softmax(score_logits, dim=1)
    return torch.einsum("bk,bkd->bd", score.to(experts.dtype), experts)


def add_towers(model, in_dim, tower_dnn_hidden_units, task_types, kw,
               device, generator):
    """Each task's tower ``tower_dnn_<i>`` (where there are tower units),
    its head ``tower_final_<i>`` and its prediction layer ``out_<i>``."""
    model.tower_dnn_hidden_units = tuple(tower_dnn_hidden_units)
    if model.tower_dnn_hidden_units:
        for i in range(len(task_types)):
            model.add_module("tower_dnn_%d" % i, DNN(
                in_dim, tower_dnn_hidden_units, **kw))
        in_dim = tower_dnn_hidden_units[-1]
    for i, task in enumerate(task_types):
        model.add_module("tower_final_%d" % i, _dense(
            in_dim, 1, use_bias=False, device=device, generator=generator))
        model.add_module("out_%d" % i, PredictionLayer(task, device=device))


def task_outputs(model, inputs, training):
    """[B, n_tasks]: each task's tower on its input (``inputs[i]``), head
    and prediction layer."""
    outs = []
    for i, h in enumerate(inputs):
        if model.tower_dnn_hidden_units:
            h = getattr(model, "tower_dnn_%d" % i)(h, training)
        logit = getattr(model, "tower_final_%d" % i)(h).float()
        outs.append(getattr(model, "out_%d" % i)(logit))
    return torch.cat(outs, dim=-1)
