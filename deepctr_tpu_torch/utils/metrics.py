"""Host-side evaluation metrics, numpy only.

Counterpart of ``deepctr_tpu/utils/metrics.py``.  The JAX package takes
``roc_auc_score`` from sklearn; here it is computed from ranks (ties get
their average rank, as sklearn's does), so the port needs no sklearn.
"""

import warnings

import numpy as np


def log_loss(y_true, y_pred, eps=1e-7):
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_pred = np.clip(np.asarray(y_pred, dtype=np.float64).reshape(-1),
                     eps, 1.0 - eps)
    return float(-np.mean(y_true * np.log(y_pred) +
                          (1.0 - y_true) * np.log(1.0 - y_pred)))


def roc_auc_score(y_true, y_pred):
    """Area under the ROC curve of binary labels: the Mann-Whitney U of
    the positives' average ranks.  Where only one class is present it
    warns and returns NaN, as the sklearn the JAX package calls does (a
    train metric of a small batch; sklearn before 1.6 raised).  A label
    matrix [n, T] (a multi-task fit's train
    metric) gives the mean of its columns' AUCs, sklearn's default
    ``average="macro"`` for a label-indicator matrix."""
    y_true = np.asarray(y_true)
    if y_true.ndim == 2 and y_true.shape[1] > 1:
        y_pred = np.asarray(y_pred)
        return float(np.mean([roc_auc_score(y_true[:, i], y_pred[:, i])
                              for i in range(y_true.shape[1])]))
    y_true = y_true.reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1)
    classes = np.unique(y_true)
    if len(classes) == 1:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.")
        return float("nan")
    if len(classes) != 2:
        raise ValueError("roc_auc_score takes binary labels, got classes %s"
                         % (classes,))
    pos = y_true == classes[1]
    order = np.argsort(y_pred, kind="mergesort")
    sorted_pred = y_pred[order]
    # average rank (1-based) of each run of tied scores
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_pred)) + 1]
    ends = np.r_[starts[1:], len(sorted_pred)]
    ranks = np.empty(len(y_pred), dtype=np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def mean_squared_error(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1)
    return float(np.mean((y_true - y_pred) ** 2))


def accuracy_score(y_true, y_pred):
    y_true = np.asarray(y_true).reshape(-1)
    y_hat = np.where(np.asarray(y_pred).reshape(-1) > 0.5, 1, 0)
    return float(np.mean(y_true == y_hat))


def resolve_metrics(metrics):
    """Name list -> {name: fn(y_true, y_pred)}."""
    out = {}
    if metrics:
        for metric in metrics:
            if metric in ("binary_crossentropy", "logloss"):
                out[metric] = log_loss
            elif metric == "auc":
                out[metric] = roc_auc_score
            elif metric == "mse":
                out[metric] = mean_squared_error
            elif metric in ("accuracy", "acc"):
                out[metric] = accuracy_score
            elif callable(metric):
                out[getattr(metric, "__name__", str(metric))] = metric
    return out
